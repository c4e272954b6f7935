"""CASIA-HWDB1.x GNT isolated-character extractor.

GNT record layout (per sample, `gnt2png.py:38-41`):
    u32 LE  record length (header + pixels)
    u16 BE  tag code (GB code of the character)
    u16 LE  width
    u16 LE  height
    H*W     grayscale pixels

Each glyph is centered on a white square (side = max(H, W)), resized to
``image_size`` and saved as ``<gnt_name>_<tagcode>.png`` — same naming and
normalization as the reference tool (`gnt2png.py:35-62`), but the pixel copy
is a single numpy slice instead of a per-pixel ``struct.unpack`` loop.

A copy of the JAX package's ``data/prep/gnt.py``; OpenCV is imported where
an image is resized and written, never at import.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zipfile
from dataclasses import dataclass
from typing import BinaryIO, Iterator

import numpy as np


@dataclass
class GntSample:
    tag_code: int      # big-endian GB code as int (reference naming)
    image: np.ndarray  # (size, size) uint8, centered on white


def iter_gnt_samples(fp: BinaryIO, total_bytes: int) -> Iterator[GntSample]:
    decoded = 0
    while decoded < total_bytes:
        head = fp.read(10)
        if len(head) < 10:
            return
        data_length = struct.unpack("<I", head[:4])[0]
        tag_code = struct.unpack(">H", head[4:6])[0]
        width = struct.unpack("<H", head[6:8])[0]
        height = struct.unpack("<H", head[8:10])[0]
        pixels = fp.read(width * height)
        if len(pixels) < width * height:
            return
        glyph = np.frombuffer(pixels, dtype=np.uint8).reshape(height, width)
        side = max(width, height)
        canvas = np.full((side, side), 255, dtype=np.uint8)
        r0 = (side - height) // 2
        c0 = (side - width) // 2
        canvas[r0: r0 + height, c0: c0 + width] = glyph
        decoded += data_length
        yield GntSample(tag_code=tag_code, image=canvas)


def gnt2png(src_file: str, image_size: int, tgt_folder: str) -> int:
    """Extract all GNT files in a zip archive; returns sample count."""
    import cv2
    if not zipfile.is_zipfile(src_file):
        sys.stderr.write("Source file should be a zipped file containing "
                         "the gnt files.\n")
        return 0
    n = 0
    with zipfile.ZipFile(src_file) as zf:
        for name in zf.namelist():
            total = zf.getinfo(name).file_size
            with zf.open(name) as fp:
                for sample in iter_gnt_samples(fp, total):
                    img = cv2.resize(sample.image, (image_size, image_size))
                    out = os.path.join(
                        tgt_folder, f"{name}_{sample.tag_code}.png")
                    cv2.imwrite(out, img)
                    n += 1
    return n


def main():
    parser = argparse.ArgumentParser(
        description="Extract isolated character images from CASIA-HWDB1.x "
                    "GNT archives")
    parser.add_argument("source", help="zip archive of .gnt files")
    parser.add_argument("image_size", type=int, help="output square size")
    parser.add_argument("target", help="output folder")
    args = parser.parse_args()
    if not (os.path.isfile(args.source) and os.path.isdir(args.target)):
        raise FileNotFoundError("Expected source file and target folder.")
    n = gnt2png(args.source, args.image_size, args.target)
    print(f"extracted {n} character images -> {args.target}")


if __name__ == "__main__":
    main()
