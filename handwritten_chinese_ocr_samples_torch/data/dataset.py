"""Text-line image dataset, on the host (the JAX package's
``data/dataset.py``).

Dataset contract (`Original_README.md:94-107`):

    <data>/{train,val,test}/*.png           grayscale text lines
    <data>/{train,val,test}_img_id_gt.txt   "img_name,label text" per line
    <data>/chars_list.txt                   one character per line

Images are read as 8-bit grayscale and resized to height ``img_h`` at the
aspect-preserving width with ``cv2.INTER_AREA``: the same OpenCV calls as
the JAX module, so the uint8 arrays are bit-identical. OpenCV is imported
where a file is read, never at import. The JAX module decodes unusual files
(16-bit, palette with alpha, four channels) with PIL; the port raises there,
naming the file.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def load_and_resize_image(path: str, img_h: int) -> np.ndarray:
    """``cv2.IMREAD_UNCHANGED`` + INTER_AREA resize to height ``img_h``, at
    ``int(width * (img_h / height))`` (`dataset.py:47-60`: the ratio first,
    then the truncation). Returns uint8 ``(img_h, new_width)``."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None or img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(
            f"{path}: not an 8-bit grayscale or BGR image that OpenCV "
            f"decodes ({None if img is None else (img.dtype, img.shape)})")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    height, width = img.shape[:2]
    new_width = int(width * (img_h / height))
    return cv2.resize(img, (new_width, img_h), interpolation=cv2.INTER_AREA)


def read_resize_image(img_path: str, height: int) -> np.ndarray:
    """cv2 imread + BGR->gray + INTER_AREA resize (the single-image eval
    path, `test.py:206-217`: ``tw = int(th * w / h)``, the ratio ``w/h``
    first)."""
    import cv2
    src = cv2.imread(img_path)
    if src is None:
        raise FileNotFoundError(img_path)
    if src.ndim == 3:
        src = cv2.cvtColor(src, cv2.COLOR_BGR2GRAY)
    ratio = float(src.shape[1]) / float(src.shape[0])
    tw = int(height * ratio)
    return cv2.resize(src, (tw, height), fx=0, fy=0,
                      interpolation=cv2.INTER_AREA)


class ImageDataset:
    """Manifest-driven dataset of (image, label) pairs.

    As `dataset.py:18-45`: reads ``<phase>_img_id_gt.txt``; skips missing
    files, zero-byte files and empty labels; ``__len__`` truncates to a
    multiple of ``batch_size``, so every batch is full.
    """

    def __init__(self, data_path: str, img_shape: Tuple[int, int],
                 phase: str, batch_size: int = 1):
        if phase not in ("train", "val", "test"):
            raise AssertionError(phase)
        self.img_c, self.img_h = img_shape[0], img_shape[1]
        self.phase = phase
        self.batch_size = batch_size
        self.data_list: List[Tuple[str, str]] = []

        manifest = os.path.join(data_path, phase + "_img_id_gt.txt")
        with open(manifest, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip("\n").split(",", 1)
                if len(parts) != 2:
                    continue
                img_path = os.path.join(data_path, phase, parts[0])
                if (os.path.exists(img_path)
                        and os.stat(img_path).st_size > 0 and parts[1]):
                    self.data_list.append((img_path, parts[1]))

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        img_path, label = self.data_list[idx]
        return load_and_resize_image(img_path, self.img_h), label

    def __len__(self) -> int:
        return self.batch_size * (len(self.data_list) // self.batch_size)
