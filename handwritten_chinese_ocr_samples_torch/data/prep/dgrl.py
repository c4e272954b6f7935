"""CASIA-HWDB2.x DGRL page extractor (the JAX package's
``data/prep/dgrl.py``; the reference's `dgrl2png.py`).

Parses the DGRL binary layout and writes per-line PNGs, hex label files and
a ``dgrl_img_gt.txt`` manifest, the JAX tool's outputs byte for byte in
pixels, labels and manifest. Two things differ in how, not in what:

  * ``resize_to_height`` is the port's own numpy resampler, equal byte for
    byte to PIL's ``Image.resize(..., LANCZOS)`` on 8-bit gray images (PIL
    is not promised where the port runs);
  * PNGs are written with OpenCV, imported where a file is written.

Binary layout (little-endian):
    header: u32 header_size; 8s format ("DGRL"); (header_size-36)s illustr;
            20s code_type; u16 code_len; u16 bits_per_pixel
    page:   u32 height; u32 width; u32 line_count
    line:   u32 char_count; char_count*code_len label bytes;
            u32 top; u32 left; u32 height; u32 width;
            bitmap (H*W gray bytes, or H*ceil(W/8) packed 1-bit rows)
"""

from __future__ import annotations

import argparse
import math
import os
import struct
import zipfile
from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

# PIL's fixed point for 8-bit resampling (``libImaging/Resample.c``)
_PRECISION_BITS = 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0


@dataclass
class DgrlHeader:
    header_size: int
    format_code: str
    illustration: str
    code_type: str
    code_length: int
    bits_per_pixel: int


@dataclass
class DgrlLine:
    image: np.ndarray  # (H, W) uint8, 255 = background
    text: str
    top: int
    left: int


def _u32(fp: BinaryIO) -> int:
    return struct.unpack("<I", fp.read(4))[0]


def read_header(fp: BinaryIO) -> DgrlHeader:
    header_size = _u32(fp)
    format_code = fp.read(8).decode("ascii", errors="ignore").rstrip("\x00")
    illustr = fp.read(header_size - 36).decode(
        "ascii", errors="ignore").rstrip("\x00")
    code_type = fp.read(20).decode("ascii", errors="ignore").rstrip("\x00")
    code_length = struct.unpack("<H", fp.read(2))[0]
    bits_per_pixel = struct.unpack("<H", fp.read(2))[0]
    return DgrlHeader(header_size, format_code, illustr, code_type,
                      code_length, bits_per_pixel)


def decode_label(label_bytes: bytes) -> str:
    """GB18030 label decode with 0xFF scrub (`dgrl2png.py:88-124`):
    0xFF bytes become spaces; ASCII bytes pass through (NUL/space dropped);
    double-byte sequences decode as GB18030, replacement chars dropped."""
    label_bytes = bytes(b if b != 0xFF else 0x20 for b in label_bytes)
    out: List[str] = []
    i = 0
    n = len(label_bytes)
    while i < n:
        b = label_bytes[i]
        if b < 0x80:
            if b not in (0x00, 0x20):
                out.append(chr(b))
            i += 1
            continue
        if i + 1 < n:
            ch = label_bytes[i: i + 2].decode("gb18030", errors="replace")
            if ch != "�":
                out.append(ch)
            i += 2
        else:
            i += 1
    return "".join(out)


def _unpack_1bit(data: bytes, height: int, width: int) -> np.ndarray:
    """Packed 1-bit rows -> uint8 image, MSB-first: a 0 bit is background
    (255) and a 1 bit is ink (0), matching `dgrl2png.py:186-191`."""
    row_bytes = (width + 7) // 8
    raw = np.frombuffer(data, dtype=np.uint8)
    if raw.size < height * row_bytes:
        raw = np.pad(raw, (0, height * row_bytes - raw.size))
    bits = np.unpackbits(raw.reshape(height, row_bytes), axis=1)[:, :width]
    return np.where(bits == 0, 255, 0).astype(np.uint8)


def iter_dgrl_lines(fp: BinaryIO,
                    max_lines: int = 100,
                    max_chars: int = 500) -> Iterator[DgrlLine]:
    """Stream text-line records from an open DGRL file."""
    header = read_header(fp)
    _page_h, _page_w = _u32(fp), _u32(fp)
    n_lines = _u32(fp)
    if n_lines == 0 or n_lines > max_lines:  # sanity guard (`dgrl2png.py:148`)
        return
    for _ in range(n_lines):
        try:
            n_chars = _u32(fp)
            if n_chars == 0 or n_chars > max_chars:
                return
            text = decode_label(fp.read(n_chars * header.code_length))
            top, left = _u32(fp), _u32(fp)
            h, w = _u32(fp), _u32(fp)
            if h == 0 or w == 0 or h > 5000 or w > 10000:
                return
            if header.bits_per_pixel == 1:
                img = _unpack_1bit(fp.read(h * ((w + 7) // 8)), h, w)
            else:
                img = np.frombuffer(fp.read(h * w),
                                    dtype=np.uint8).reshape(h, w)
            if text:
                yield DgrlLine(image=img, text=text, top=top, left=left)
        except (struct.error, ValueError):
            return


# ------------------------------------------------------------ resampling
def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for one axis:
    per output index its first input index and its int32 weights (22
    fractional bits, rounded half away from zero). The weights are
    computed in double with libm's ``sin``, in PIL's order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ss = 1.0 / filterscale
    one = 1 << _PRECISION_BITS
    starts, weights = [], []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        starts.append(xmin)
        weights.append([int(-0.5 + w * one) if w < 0 else int(0.5 + w * one)
                        for w in k])
    return starts, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass along ``axis`` of a uint8 image: int64 sums of
    pixel x weight from ``1 << 21``, ``>> 22``, clipped to [0, 255]."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    starts, weights = _lanczos_coeffs(src.shape[0], out_size)
    out = np.empty((out_size,) + src.shape[1:], dtype=np.uint8)
    for i, (lo, k) in enumerate(zip(starts, weights)):
        acc = np.full(src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
        acc += np.tensordot(np.asarray(k, np.int64), src[lo: lo + len(k)],
                            axes=(0, 0))
        out[i] = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def lanczos_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """A uint8 ``(H, W)`` image resized to ``(height, width)`` as PIL's
    ``Image.fromarray(img).resize((width, height), Image.LANCZOS)``: the
    horizontal pass, then the vertical one, an axis whose size does not
    change skipped."""
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != img.shape[0]:
        out = _resample_axis(out, height, 0)
    return np.ascontiguousarray(out)


def resize_to_height(img: np.ndarray, target_height: int) -> np.ndarray:
    """LANCZOS aspect-preserving resize (`dgrl2png.py:249-255`)."""
    h, w = img.shape
    new_w = max(1, int(w * (target_height / h)))
    return lanczos_resize(img, new_w, target_height)


def _char_hex(ch: str) -> Optional[str]:
    try:
        return ch.encode("gb18030").hex().upper()
    except UnicodeEncodeError:
        return None


def process_file(fp: BinaryIO, file_name: str, tgt_folder: str,
                 target_height: Optional[int] = None
                 ) -> Tuple[List[str], List[str]]:
    """One DGRL -> per-line PNG + hex label txt; returns (paths, texts)."""
    import cv2
    base = os.path.splitext(os.path.basename(file_name))[0]
    paths, texts = [], []
    for idx, line in enumerate(iter_dgrl_lines(fp)):
        img = line.image
        if target_height is not None and img.shape[0] > 0:
            img = resize_to_height(img, target_height)
        stem = os.path.join(tgt_folder, f"{base}-L{idx + 1}")
        if not cv2.imwrite(stem + ".png", img):
            raise OSError(f"cannot write {stem}.png")
        with open(stem + ".txt", "w", encoding="utf-8") as lf:
            for ch in line.text:
                hx = _char_hex(ch)
                if hx:
                    lf.write(hx + "\n")
        paths.append(stem + ".png")
        texts.append(line.text)
    return paths, texts


def dgrl2png(src_path: str, tgt_folder: str,
             target_height: Optional[int] = None) -> Tuple[int, str]:
    """Extract a file / directory / zip of DGRLs; write manifest.

    Returns (number of lines, manifest path)."""
    os.makedirs(tgt_folder, exist_ok=True)
    all_paths: List[str] = []
    all_texts: List[str] = []

    def handle(fp, name):
        p, t = process_file(fp, name, tgt_folder, target_height)
        all_paths.extend(p)
        all_texts.extend(t)

    if zipfile.is_zipfile(src_path):
        with zipfile.ZipFile(src_path) as zf:
            for name in zf.namelist():
                if name.lower().endswith(".dgrl"):
                    with zf.open(name) as fp:
                        handle(fp, name)
    elif os.path.isdir(src_path):
        for name in sorted(os.listdir(src_path)):
            if name.lower().endswith(".dgrl"):
                with open(os.path.join(src_path, name), "rb") as fp:
                    handle(fp, name)
    elif os.path.isfile(src_path):
        with open(src_path, "rb") as fp:
            handle(fp, src_path)
    else:
        raise FileNotFoundError(src_path)

    manifest = os.path.join(tgt_folder, "dgrl_img_gt.txt")
    with open(manifest, "w", encoding="utf-8") as f:
        for p, t in zip(all_paths, all_texts):
            f.write(f"{os.path.basename(p)},{t}\n")
    return len(all_paths), manifest


def generate_file_list(src_path: str, output_file: str) -> int:
    """List .dgrl members of a dir/zip (``--list_only``,
    `dgrl2png.py:360-381`)."""
    if zipfile.is_zipfile(src_path):
        with zipfile.ZipFile(src_path) as zf:
            files = [n for n in zf.namelist()
                     if n.lower().endswith(".dgrl")]
    elif os.path.isdir(src_path):
        files = [os.path.join(src_path, n) for n in os.listdir(src_path)
                 if n.lower().endswith(".dgrl")]
    else:
        files = []
    with open(output_file, "w") as f:
        for name in sorted(files):
            f.write(name + "\n")
    return len(files)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract text line images from DGRL files "
                    "(CASIA-HWDB2.x format)")
    parser.add_argument("source", help="DGRL file, directory, or zip")
    parser.add_argument("target", nargs="?", default="./extracted_dgrl_data")
    parser.add_argument("--image_height", type=int, default=None,
                        help="target height (aspect preserved)")
    parser.add_argument("--list_only", type=str, default=None,
                        help="only write the file list")
    args = parser.parse_args(argv)
    if args.list_only:
        n = generate_file_list(args.source, args.list_only)
        print(f"wrote {n} entries -> {args.list_only}")
    else:
        n, manifest = dgrl2png(args.source, args.target, args.image_height)
        print(f"extracted {n} lines; manifest: {manifest}")


if __name__ == "__main__":
    main()
