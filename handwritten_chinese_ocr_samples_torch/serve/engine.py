"""Fixed-width serving engine (the JAX package's ``serve/engine.py``).

Requests are padded to a fixed set of width buckets; each batch runs
normalise -> forward -> decode on the device, and only compact index rows
come back to the host for the string join. The decode routes (greedy, the
device beam, the LM-fused device search and the host beam) live in
``decode/routes``, which the eval driver shares.

Preprocessing parity with the JAX engine: grayscale, resize to the model
height (area interpolation), fixed width — truncate on the right if wider,
else pad with white then replicate the right edge — and normalise
``(x - 127.5) / 127.5``. Image files are decoded with OpenCV, imported only
when a file is read; array input needs no image library.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..decode.routes import build_route
from . import quant


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
    ``greedy-search`` or ``beam-search``; a beam search with ``lm`` (a
    ``decode/lm_interface.TorchLMBackend``) and ``use_lm_score`` runs the
    LM-fused device search, with the LM in bf16 unless ``lm_f32``, the skip
    search with ``skip_search`` (``prune`` is its ambiguity threshold, a
    probability; ``seg_budget``, ``run_max``, ``ctx_ladder`` and
    ``fused_commit`` are ``decode/adaptive.AdaptiveLMBeam``'s). The other
    beam configurations that consult an LM or skip frames take the host
    beam (``lm`` a ``KenLMBackend`` or a ``TorchLMBackend``), as in the JAX
    engine; no route falls back to another.

    ``int8`` serves the recognizer's conv sites in int8 (``serve/quant``):
    the first batch calibrates them (``_quant`` is None until then) and the
    int8 state goes onto ``model``'s sites. ``lm_int8`` runs the device LM
    search's step in int8 and is ignored on the other routes, as in the JAX
    engine.
    """

    def __init__(self, model: torch.nn.Module, state_dict, codec,
                 widths: Sequence[int] = (512, 1024, 1600),
                 decode_method: str = "greedy-search",
                 beam_size: int = 10,
                 search_depth: int = 10,
                 lm_panelty: float = 1.9,
                 len_bonus: float = 5.7,
                 lm=None,
                 use_lm_pred: bool = False,
                 use_lm_score: bool = False,
                 skip_search: bool = False,
                 lm_ctx: int = 0,
                 lm_group: int = 8,
                 seg_budget: int = 0,
                 run_max: int = 8,
                 ctx_ladder: int = 112,
                 fused_commit: bool = False,
                 lm_f32: bool = False,
                 lm_int8: bool = False,
                 int8: bool = False,
                 prune: float = 0.001,
                 device: str | torch.device = "cuda"):
        if int8 and not quant.supports_quant(model):
            raise ValueError("int8: this model has no quantized conv path")
        self._int8 = bool(int8)
        self._quant = None
        self.device = torch.device(device)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.codec = codec
        self.widths = sorted(widths)
        self.route = build_route(
            codec, decode_method, lm, use_lm_pred=use_lm_pred,
            use_lm_score=use_lm_score, skip_search=skip_search,
            beam_size=beam_size, search_depth=search_depth,
            lm_panelty=lm_panelty, len_bonus=len_bonus, prune=prune,
            lm_f32=lm_f32, lm_int8=lm_int8, lm_group=lm_group, lm_ctx=lm_ctx,
            seg_budget=seg_budget, run_max=run_max, ctx_ladder=ctx_ladder,
            fused_commit=fused_commit, device=self.device)
        self._device_lm_beam = self.route.name == "lm"
        self._lm_beam = self.route.lm_beam
        self._host_beam = self.route.host
        self._prune_lp = self.route.prune_lp

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
    def dispatch_batch(self, batch_u8: np.ndarray
                       ) -> Callable[[], List[str]]:
        """Queue the forward and the decode's device work of a ``(b, H, W,
        1)`` uint8 batch; returns ``finalize() -> one text per row``, the
        host tail (D2H, the LM search's host loop, strings)."""
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        x = (x.float() - 127.5) / 127.5
        if self._int8 and self._quant is None:
            self._quant = quant.calibrate_for_model(self.model, [x])
        return self.route.dispatch(self.model(x))

    def infer_batch(self, batch_u8: np.ndarray) -> List[str]:
        """``(b, H, W, 1)`` uint8 batch -> one text per row."""
        return self.dispatch_batch(batch_u8)()

    @torch.inference_mode()
    def decode_logits(self, logits: torch.Tensor) -> List[str]:
        """``(b, T, D)`` logits -> one text per row, on this engine's
        decode route."""
        return self.route.dispatch(logits)()

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
        repetition and cut after decode. One batch in flight, as in the JAX
        engine: batch k+1's forward and decode dispatch are queued before
        batch k's host tail runs."""
        groups: Dict[int, List[int]] = {}
        for i, (w, _) in enumerate(items):
            groups.setdefault(w, []).append(i)
        texts: List[str] = [""] * len(items)

        def consume(entry):
            chunk, finalize = entry
            for i, t in zip(chunk, finalize()):
                texts[i] = t

        t0 = time.perf_counter()
        prev = None
        for idxs in groups.values():
            bs = min(batch_size, len(idxs))
            for s in range(0, len(idxs), bs):
                chunk = idxs[s: s + bs]
                batch = np.concatenate(
                    [items[i][1] for i in chunk]
                    + [items[chunk[-1]][1]] * (bs - len(chunk)), axis=0)
                pending = (chunk, self.dispatch_batch(batch))
                if prev is not None:
                    consume(prev)
                prev = pending
        if prev is not None:
            consume(prev)
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
