"""Fixed-width serving engine (the JAX package's ``serve/engine.py``).

Requests are padded to a fixed set of width buckets; each batch runs
normalise -> forward -> decode on the device, and only compact index rows
come back to the host for the string join. Three decode routes:

  * ``greedy-search``: argmax + CTC collapse on the device (``ops/decode``);
  * ``beam-search`` (no LM): the fused log-softmax + top-K kernel feeding the
    device prefix beam search (``decode/beam_device``);
  * ``beam-search`` with a transformer LM and ``use_lm_score``: the fused
    top-K (kernel K1, with its blank log-prob and its count of classes
    above ``prune``) and the frame log-partition feeding the LM-fused
    device search (``decode/adaptive`` over ``decode/beam_lm_device``,
    kernels K2-K4): the skip search with ``skip_search`` (the production
    route), else the full per-frame search.

Preprocessing parity with the JAX engine: grayscale, resize to the model
height (area interpolation), fixed width — truncate on the right if wider,
else pad with white then replicate the right edge — and normalise
``(x - 127.5) / 127.5``. Image files are decoded with OpenCV, imported only
when a file is read; array input needs no image library.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..decode.beam_device import beam_search_fused
from ..ops import topk_logsoftmax as _k1
from ..ops.decode import greedy_decode_device

# Routes of the JAX engine that later slices port (ROADMAP.md, queue 1).
_LATER = {
    "host_beam": "the host beam search, which serves -utp without -uts and "
                 "a KenLM n-gram (ROADMAP.md queue 1, item 3)",
    "int8": "int8 serving and int8 LM matmuls (ROADMAP.md queue 1, "
            "item 5)",
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
    ``greedy-search`` or ``beam-search``; a beam search with ``lm`` (a
    ``decode/lm_interface.TorchLMBackend``) and ``use_lm_score`` runs the
    LM-fused device search, with the LM in bf16 unless ``lm_f32``, the skip
    search with ``skip_search`` (``prune`` is its ambiguity threshold, a
    probability; ``seg_budget``, ``run_max``, ``ctx_ladder`` and
    ``fused_commit`` are ``decode/adaptive.AdaptiveLMBeam``'s). The JAX
    engine's host-beam route (which also serves ``skip_search`` without a
    transformer LM) and int8 routes raise ``NotImplementedError`` until the
    port has them; none falls back to another route.
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
        if decode_method not in ("greedy-search", "beam-search"):
            raise ValueError(f"unknown decode method {decode_method!r}")
        use_beam = decode_method == "beam-search"
        # routing as in the JAX engine: a transformer LM (it has lm_model)
        # with LM scoring takes the LM-fused device search; the skip search
        # or LM scoring without one, and LM proposals without scoring,
        # belong to the host beam; an LM that is neither scored nor
        # proposing is ignored, and the plain device beam serves
        is_tfm = lm is not None and hasattr(lm, "lm_model")
        self._device_lm_beam = use_beam and use_lm_score and is_tfm
        if int8 or (self._device_lm_beam and lm_int8):
            raise NotImplementedError(f"not ported yet: {_LATER['int8']}")
        if use_beam and not self._device_lm_beam and (
                skip_search or use_lm_score
                or (lm is not None and use_lm_pred)):
            raise NotImplementedError(
                f"not ported yet: {_LATER['host_beam']}")
        self.device = torch.device(device)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.codec = codec
        self.widths = sorted(widths)
        self.decode_method = decode_method
        self.beam_size = beam_size
        self.search_depth = search_depth
        self.len_bonus = len_bonus
        self._prune_lp = math.log(prune)
        if self._device_lm_beam:
            from ..decode.adaptive import AdaptiveLMBeam
            from ..decode.beam_lm_device import make_id_tables
            from ..lm.cached import CachedLM
            clm = CachedLM(lm.lm_model, lm.lm_params,
                           dtype=torch.float32 if lm_f32 else torch.bfloat16,
                           device=self.device)
            c2l, l2c = make_id_tables(codec, lm.tokenizer)
            self._lm_beam = AdaptiveLMBeam(
                clm, c2l, l2c, beam_size=beam_size, depth=search_depth,
                unknown_id=codec.unknown_id, lm_panelty=lm_panelty,
                len_bonus=len_bonus, use_lm_pred=use_lm_pred,
                skip_search=skip_search, group_size=lm_group, lm_ctx=lm_ctx,
                seg_budget=seg_budget, run_max=run_max,
                ctx_ladder=ctx_ladder, fused_commit=fused_commit,
                prune=self._prune_lp)

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
        return self.decode_logits(self.model((x.float() - 127.5) / 127.5))

    @torch.inference_mode()
    def decode_logits(self, logits: torch.Tensor) -> List[str]:
        """``(b, T, D)`` f32 logits -> one text per row, on this engine's
        decode route."""
        unknown_id = self.codec.unknown_id
        if self._device_lm_beam:
            cv, ci, blank_lp, n_above = _k1.topk_logsoftmax(
                logits, k=self.search_depth, prune=self._prune_lp)
            logz = torch.logsumexp(logits.float(), dim=-1)
            chars, lengths = self._lm_beam.decode(cv, ci, logits, logz,
                                                  blank_lp, n_above)
        elif self.decode_method == "beam-search":
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
