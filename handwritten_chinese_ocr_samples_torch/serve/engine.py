"""Fixed-width serving engine (the JAX package's ``serve/engine.py``).

Requests are padded to a fixed set of width buckets; each batch runs
normalise -> forward -> decode on the device, and only compact index rows
come back to the host for the string join. Two decode routes:

  * ``greedy-search``: argmax + CTC collapse on the device (``ops/decode``);
  * ``beam-search`` (no LM): the fused log-softmax + top-K kernel feeding the
    device prefix beam search (``decode/beam_device``).

Preprocessing parity with the JAX engine: grayscale, resize to the model
height (area interpolation), fixed width — truncate on the right if wider,
else pad with white then replicate the right edge — and normalise
``(x - 127.5) / 127.5``. Image files are decoded with OpenCV, imported only
when a file is read; array input needs no image library.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..decode.beam_device import beam_search_fused
from ..ops.decode import greedy_decode_device

# Routes of the JAX engine that later slices port (ROADMAP.md, queue 1).
_LATER = {
    "lm": "the char LM and LM-fused beam search (ROADMAP.md queue 1, "
          "items 6-7)",
    "skip_search": "skip search (ROADMAP.md queue 1, items 7 and 14: the "
                   "LM-fused search and the host beam search)",
    "int8": "int8 serving (ROADMAP.md queue 1, item 10)",
}


def _read_gray(image_file: str) -> np.ndarray:
    import cv2  # file decoding only; array input never imports it
    src = cv2.imread(image_file)
    if src is None:
        raise FileNotFoundError(image_file)
    if src.ndim == 3:
        src = cv2.cvtColor(src, cv2.COLOR_BGR2GRAY)
    return src


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` interpolation weights of OpenCV's INTER_AREA along
    one axis: exact pixel-area averaging when shrinking, and OpenCV's
    area-mode linear weights when enlarging."""
    w = np.zeros((n_out, n_in), dtype=np.float64)
    scale = n_in / n_out
    if n_out <= n_in:
        for o in range(n_out):
            lo, hi = o * scale, (o + 1) * scale
            for i in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
                w[o, i] = min(hi, i + 1) - max(lo, i)
        return w / scale
    inv = n_out / n_in
    for o in range(n_out):
        s = int(np.floor(o * scale))
        f = (o + 1) - (s + 1) * inv
        f = 0.0 if f <= 0 else f - np.floor(f)
        if s >= n_in - 1:
            s, f = n_in - 1, 0.0
        w[o, s] += 1.0 - f
        if f:
            w[o, s + 1] += f
    return w


def _resize_area(src: np.ndarray, height: int, width: int) -> np.ndarray:
    wy = _area_weights(src.shape[0], height)
    wx = _area_weights(src.shape[1], width)
    out = wy @ src.astype(np.float64) @ wx.T
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _pad_fixed_shape(src: np.ndarray, height: int, width: int) -> np.ndarray:
    """(h, w) uint8 -> (1, height, width, 1) uint8, reference-parity pad."""
    h, w = src.shape
    if h != height:
        src = _resize_area(src, height, int(height * (w / h)))
    h, w = src.shape
    if w >= width:
        pad_img = src[:, :width]
    else:
        pad_img = np.full((h, width), 255, dtype=np.uint8)
        pad_img[:, :w] = src
        pad_img[:, w:] = src[:, -1:]
    return pad_img[None, :, :, None]


def preprocess_fixed_shape(image_file: str, height: int,
                           width: int) -> np.ndarray:
    """Image file -> (1, H, W, 1) uint8, reference-parity padding."""
    return _pad_fixed_shape(_read_gray(image_file), height, width)


class ServingEngine:
    """OCR server over fixed width buckets.

    The weights go to ``device`` once, at construction. ``decode_method`` is
    ``greedy-search`` or ``beam-search`` (device beam, no LM); the JAX
    engine's LM, host-beam, skip-search and int8 routes raise
    ``NotImplementedError`` until the port has them.
    """

    def __init__(self, model: torch.nn.Module, state_dict, codec,
                 widths: Sequence[int] = (512, 1024, 1600),
                 decode_method: str = "greedy-search",
                 beam_size: int = 10,
                 search_depth: int = 10,
                 len_bonus: float = 5.7,
                 lm=None,
                 use_lm_pred: bool = False,
                 use_lm_score: bool = False,
                 skip_search: bool = False,
                 int8: bool = False,
                 device: str | torch.device = "cuda"):
        if lm is not None or use_lm_pred or use_lm_score:
            raise NotImplementedError(f"not ported yet: {_LATER['lm']}")
        if skip_search:
            raise NotImplementedError(
                f"not ported yet: {_LATER['skip_search']}")
        if int8:
            raise NotImplementedError(f"not ported yet: {_LATER['int8']}")
        if decode_method not in ("greedy-search", "beam-search"):
            raise ValueError(f"unknown decode method {decode_method!r}")
        self.device = torch.device(device)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.codec = codec
        self.widths = sorted(widths)
        self.decode_method = decode_method
        self.beam_size = beam_size
        self.search_depth = search_depth
        self.len_bonus = len_bonus

    def bucket_for(self, width: int) -> int:
        for w in self.widths:
            if width <= w:
                return w
        return self.widths[-1]

    def preprocess_array(self, src: np.ndarray):
        """(h, w) uint8 grayscale -> ``(bucket_width, (1, H, W, 1) uint8)``:
        the bucket comes from the width at model height, before padding."""
        if src.ndim != 2 or src.dtype != np.uint8:
            raise ValueError(f"expected a (h, w) uint8 image, got "
                             f"{src.shape} {src.dtype}")
        h = self.model.img_height
        w = self.bucket_for(int(h * src.shape[1] / src.shape[0]))
        return w, _pad_fixed_shape(src, h, w)

    def preprocess_bucketed(self, image_file: str):
        """Read + decode an image file once, then ``preprocess_array``."""
        return self.preprocess_array(_read_gray(image_file))

    @torch.inference_mode()
    def infer_batch(self, batch_u8: np.ndarray) -> List[str]:
        """``(b, H, W, 1)`` uint8 batch -> one text per row."""
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        x = (x.float() - 127.5) / 127.5
        logits = self.model(x)
        unknown_id = self.codec.unknown_id
        if self.decode_method == "beam-search":
            chars, lengths = beam_search_fused(
                logits, beam_size=self.beam_size, depth=self.search_depth,
                unknown_id=unknown_id, blank_id=self.codec.blank_id,
                len_bonus=self.len_bonus)
        else:
            chars, lengths = greedy_decode_device(
                logits, unknown_id=unknown_id, blank_id=self.codec.blank_id)
        return self.codec.compact_to_texts(chars.cpu().numpy(),
                                           lengths.cpu().numpy())

    def infer_files(self, image_files: Sequence[str],
                    iterations: int = 1) -> Tuple[List[str], float]:
        """Serve images one by one; returns (texts, avg latency ms)."""
        texts: List[str] = []
        times: List[float] = []
        for f in image_files:
            _, x = self.preprocess_bucketed(f)
            for _ in range(iterations):
                t0 = time.perf_counter()
                text = self.infer_batch(x)[0]
                times.append((time.perf_counter() - t0) * 1000)
            texts.append(text)
        return texts, float(np.mean(times)) if times else 0.0

    def _infer_bucketed(self, items, batch_size: int):
        """``[(bucket_width, (1, H, W, 1) array)]`` -> texts in input order
        plus lines/sec; batches per bucket, the last one padded by
        repetition and cut after decode."""
        groups: Dict[int, List[int]] = {}
        for i, (w, _) in enumerate(items):
            groups.setdefault(w, []).append(i)
        texts: List[str] = [""] * len(items)
        t0 = time.perf_counter()
        for idxs in groups.values():
            bs = min(batch_size, len(idxs))
            for s in range(0, len(idxs), bs):
                chunk = idxs[s: s + bs]
                batch = np.concatenate(
                    [items[i][1] for i in chunk]
                    + [items[chunk[-1]][1]] * (bs - len(chunk)), axis=0)
                for i, t in zip(chunk, self.infer_batch(batch)):
                    texts[i] = t
        dt = time.perf_counter() - t0
        return texts, (len(items) / dt if dt > 0 else 0.0)

    def infer_files_batched(self, image_files: Sequence[str],
                            batch_size: int = 8) -> Tuple[List[str], float]:
        """Throughput serving of files: width-bucketed fixed-shape batches.
        Returns texts in input order plus lines/sec."""
        return self._infer_bucketed(
            [self.preprocess_bucketed(f) for f in image_files], batch_size)

    def infer_arrays(self, images: Sequence[np.ndarray],
                     batch_size: int = 8) -> Tuple[List[str], float]:
        """``infer_files_batched`` for ``(h, w)`` uint8 arrays."""
        return self._infer_bucketed(
            [self.preprocess_array(a) for a in images], batch_size)
