"""DGR page extractor and text-line synthesizer (CASIA-HWDB legacy format):
the port of the JAX package's ``native/dgr2png.cc`` (the reference's
`utils/casia-hwdb-data-preparation/dgr2png.c`), in numpy and OpenCV's Python
API instead of C++ against OpenCV's C++ library.

Parses the DGR document format, rebuilds each text line word by word,
normalises it to height 128 and writes per-line PNGs plus GB-code hex label
files. In synthesis mode each word bitmap whose label is not in the
alpha/symbol list is replaced by the next isolated HWDB1.x character image
of an ``img_gt`` csv (its label too), pass after pass over the page list,
until that csv runs dry.

DGR binary layout (little-endian):
  header: i32 header_size; char[8] format code ("DGR");
          char[header_size-36] illustration text; char[20] code type;
          i16 code length; i16 bits per pixel;
  doc:    i32 height; i32 width; i32 line_count;
  line:   i32 word_count; then per word:
          u8[code_len] label; i16 top; i16 left; i16 height; i16 width;
          u8[height*width] gray bitmap (255 = background).

CLI contract (the C++ tool's):
  python -m handwritten_chinese_ocr_samples_torch.data.prep.dgr \\
      <dgr list file> <output folder>                          # extract
  python -m ... <dgr list> <out> <hwdb1x img_gt csv> <alpha-symbol hex list>
                                                               # synthesize
Outputs: ``<base>-L<k>[-S<iter>].png`` + ``<base>-L<k>[-S<iter>].txt``.

The C++ tool's arithmetic is kept where it decides pixels: a tall line's
width is ``int(128 * (float(w) / h))`` in float32; a line's pixel of 255
never overwrites (ink wins, a later word's ink over an earlier one's); a
short line is centred at row ``(128 - h) // 2``; a glyph is resized with
OpenCV's default ``INTER_LINEAR`` to ``min(h, w)`` squared at the word's
top left. One guard is added: a synthesis pass that replaces nothing (no
word outside the alpha/symbol list) ends the synthesis, where the C++ tool
would loop forever.
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

TARGET_HEIGHT = 128


class Word:
    __slots__ = ("hex_label", "top", "left", "height", "width", "pixels")

    def __init__(self, hex_label: str, top: int, left: int, height: int,
                 width: int, pixels: np.ndarray):
        self.hex_label = hex_label
        self.top, self.left = top, left
        self.height, self.width = height, width
        self.pixels = pixels                    # (height, width) uint8


class SynthSource:
    """The replacement stream: ``path,hexcode[,...]`` rows of HWDB1.x
    character images, consumed in order across every page and pass, and
    the alpha/symbol codes that are never replaced."""

    def __init__(self, img_gt_csv: str, alpha_symbols_path: str):
        with open(img_gt_csv, "rb") as f:
            self._rows: Iterator[bytes] = iter(f.read().split(b"\n"))
        self.replaced = 0           # replacements taken (in this pass)
        self._keep = set()
        if os.path.exists(alpha_symbols_path):
            with open(alpha_symbols_path, "rb") as f:
                for hx in f.read().split(b"\n"):
                    hx = hx[:-1] if hx.endswith(b"\r") else hx
                    if hx:
                        self._keep.add(hx.decode("latin-1"))

    def should_keep(self, hex_label: str) -> bool:
        return hex_label in self._keep

    def next(self) -> Optional[Tuple[str, str]]:
        """The next ``(image path, label hex)``; None once exhausted (at
        the end, or at a row without a comma)."""
        row = next(self._rows, None)
        if row is None or b"," not in row:
            return None
        path, rest = row.split(b",", 1)
        label = rest.split(b",", 1)[0]
        return path.decode("utf-8", "surrogateescape"), label.decode(
            "latin-1")


def parse_dgr(data: bytes, synth: Optional[SynthSource] = None
              ) -> Tuple[List[List[Word]], bool]:
    """One DGR file's lines of words. A truncated or malformed file gives
    the lines read before the fault. With ``synth`` the replaceable words
    take the next replacement glyph and label; the second value is False
    iff the replacements ran out mid-page (the lines before that page's
    current line are kept)."""
    import cv2
    lines: List[List[Word]] = []
    off = 0

    def take(fmt: str):
        nonlocal off
        size = struct.calcsize(fmt)
        if off + size > len(data):
            raise EOFError
        vals = struct.unpack_from(fmt, data, off)
        off += size
        return vals

    try:
        header_size, = take("<i")
        take("8s")
        if header_size < 36 or off + header_size - 36 > len(data):
            return lines, True
        off += header_size - 36                 # the illustration text
        take("20s")
        code_len, _bits_pp = take("<hh")
        _doc_h, _doc_w, n_lines = take("<iii")
        if code_len <= 0 or code_len > 8 or n_lines < 0:
            return lines, True
        for _ in range(n_lines):
            n_words, = take("<i")
            if n_words < 0:
                return lines, True
            words = []
            for _ in range(n_words):
                code = take(f"{code_len}s")[0]
                top, left, hei, wid = take("<hhhh")
                h, w = max(0, hei), max(0, wid)
                pixels = np.full((h, w), 255, np.uint8)
                if h * w:
                    pixels = np.frombuffer(take(f"{h * w}s")[0],
                                           np.uint8).reshape(h, w).copy()
                word = Word(code.hex().upper(), top, left, h, w, pixels)
                if (synth is not None and not synth.should_keep(
                        word.hex_label) and h > 0 and w > 0):
                    repl = synth.next()
                    if repl is None:
                        return lines, False
                    synth.replaced += 1
                    glyph = cv2.imread(repl[0], cv2.IMREAD_GRAYSCALE)
                    if glyph is not None and glyph.size:
                        edge = min(h, w)     # square glyphs compose best
                        word.pixels[:] = 255
                        word.pixels[:edge, :edge] = cv2.resize(
                            glyph, (edge, edge))
                        word.hex_label = repl[1]
                words.append(word)
            lines.append(words)
    except EOFError:
        pass
    return lines, True


def render_line(words: List[Word]) -> Optional[np.ndarray]:
    """A line's words composed on white and normalised to height 128: a
    taller line resized down (``INTER_LINEAR``), a shorter one centred.
    None for an empty line."""
    import cv2
    if not words:
        return None
    top = min(w.top for w in words)
    bottom = max(0, max(w.top + w.height for w in words))
    left = min(max(w.left, 0) for w in words)
    right = max(0, max(w.left + w.width for w in words))
    h, wdt = bottom - top, right - left
    if h <= 0 or wdt <= 0:
        return None
    canvas = np.full((h, wdt), 255, np.uint8)
    for w in words:
        y0, x0 = w.top - top, w.left - left
        ys = slice(max(0, -y0), min(w.height, h - y0))
        xs = slice(max(0, -x0), min(w.width, wdt - x0))
        src = w.pixels[ys, xs]
        if not src.size:
            continue
        dst = canvas[y0 + ys.start: y0 + ys.stop, x0 + xs.start: x0 + xs.stop]
        ink = src != 255
        dst[ink] = src[ink]                      # ink wins
    if h > TARGET_HEIGHT:
        tw = int(np.float32(TARGET_HEIGHT)
                 * (np.float32(wdt) / np.float32(h)))
        return cv2.resize(canvas, (max(tw, 1), TARGET_HEIGHT))
    out = np.full((TARGET_HEIGHT, wdt), 255, np.uint8)
    y = (TARGET_HEIGHT - h) // 2
    out[y: y + h] = canvas
    return out


def _base_name(path: str) -> str:
    name = path.rsplit("/", 1)[-1]
    return name.rsplit(".", 1)[0] if "." in name else name


def process_file(dgr_path: str, out_dir: str,
                 synth: Optional[SynthSource] = None,
                 suffix: str = "") -> bool:
    """One DGR file -> ``<base>-L<k><suffix>.png/.txt`` per non-empty
    line. Returns False iff the synthesis source ran dry."""
    import cv2
    try:
        with open(dgr_path, "rb") as f:
            data = f.read()
    except OSError:
        sys.stderr.write(f"cannot open {dgr_path}\n")
        return True
    lines, ok = parse_dgr(data, synth)
    base = _base_name(dgr_path)
    for i, words in enumerate(lines):
        img = render_line(words)
        if img is None:
            continue
        stem = f"{out_dir}/{base}-L{i + 1}{suffix}"
        if not cv2.imwrite(stem + ".png", img):
            raise OSError(f"cannot write {stem}.png")
        with open(stem + ".txt", "w", encoding="latin-1", newline="") as f:
            f.writelines(w.hex_label + "\n" for w in words)
    print(f"{dgr_path}: {len(lines)} lines"
          + ("" if ok else " (synthesis source exhausted)"))
    return ok


def _list(list_path: str) -> List[str]:
    with open(list_path, "rb") as f:
        return [p.decode("utf-8", "surrogateescape")
                for p in f.read().split(b"\n") if p]


def dgr2png(list_path: str, out_dir: str, img_gt_csv: Optional[str] = None,
            alpha_symbols: Optional[str] = None) -> int:
    """The tool: extract every DGR of the list, or with ``img_gt_csv`` and
    ``alpha_symbols`` synthesise ``-S1``, ``-S2``, ... passes until the
    csv runs dry. Returns the exit code."""
    if not os.path.exists(out_dir):
        sys.stderr.write(f"output folder does not exist: {out_dir}\n")
        return 1
    if not os.path.isfile(list_path):
        sys.stderr.write(f"cannot open list {list_path}\n")
        return 1
    if img_gt_csv is None:
        for path in _list(list_path):
            process_file(path, out_dir)
        return 0
    if not os.path.isfile(img_gt_csv):
        sys.stderr.write(f"cannot open img_gt csv {img_gt_csv}\n")
        return 1
    synth = SynthSource(img_gt_csv, alpha_symbols)
    more, it = True, 1
    while more:
        synth.replaced = 0
        for path in _list(list_path):
            if not process_file(path, out_dir, synth, f"-S{it}"):
                more = False
                break
        if synth.replaced == 0:       # nothing replaceable: would not end
            break
        it += 1
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 4):
        sys.stderr.write(
            "USAGE: dgr <dgr list file> <output folder> [hwdb1x img_gt "
            "csv] [alpha-symbol hex list]\n")
        return 1
    return dgr2png(*argv)


if __name__ == "__main__":
    sys.exit(main())
