"""Width-bucketed batching with reference-parity padding (the JAX package's
``data/bucketing.py``, a copy: numpy only).

The reference pads each batch to its dynamic max width (`dataset.py:96-132`).
Here the padded width is rounded **up to a bucket** from a small fixed set,
as the JAX package does (there, to bound its compiled executables), so the
port's eval pads every batch exactly as the JAX eval does.

Padding math parity with ``NormalizePAD`` (`dataset.py:78-93`): to-tensor
(uint8/255), normalize ``(x - 0.5) / 0.5``, right-pad replicating the last
image column. The pad columns genuinely feed the model and the CTC time axis,
exactly as in the reference (`main.py:388`). ``ZerosPAD`` (`dataset.py:64-75`)
right-pads with zeros and skips normalization.

Width-cap semantics parity (`dataset.py:108-128`): widths above ``max_width``
are truncated and labels are truncated proportionally.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np


def default_buckets(max_width: int = 1600, step: int = 128) -> Tuple[int, ...]:
    """Bucket widths: multiples of ``step`` up to and including the cap."""
    buckets = list(range(step, max_width + 1, step))
    if buckets[-1] != max_width:
        buckets.append(max_width)
    return tuple(buckets)


@dataclass(frozen=True)
class BucketSpec:
    widths: Tuple[int, ...] = field(default_factory=default_buckets)

    def bucket_for(self, w: int) -> int:
        """Smallest bucket >= w (widths above the cap use the cap)."""
        i = bisect.bisect_left(self.widths, w)
        return self.widths[min(i, len(self.widths) - 1)]


def normalize_pad_batch(
    images: Sequence[np.ndarray],  # each (H, w) uint8
    target_w: int,
    pad: str = "NormalizePAD",
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-width grayscale lines into (B, H, target_w, 1) float32.

    Returns ``(batch, widths)`` where ``widths[b]`` is the un-padded width
    (post-truncation). Replicated-edge padding matches `dataset.py:89-92`.
    """
    B = len(images)
    H = images[0].shape[0]
    out = np.zeros((B, H, target_w, 1), dtype=np.float32)
    widths = np.zeros((B,), dtype=np.int32)
    for b, img in enumerate(images):
        w = min(img.shape[1], target_w)
        x = img[:, :w].astype(np.float32) / 255.0
        if pad == "NormalizePAD":
            x = (x - 0.5) / 0.5
        elif pad != "ZerosPAD":
            raise ValueError(f"not expected padding: {pad}")
        out[b, :, :w, 0] = x
        if pad == "NormalizePAD" and w < target_w:
            out[b, :, w:, 0] = x[:, w - 1: w]
        widths[b] = w
    return out, widths


class AlignCollate:
    """Batch collation: width cap, proportional label truncation, bucketing.

    Mirrors ``AlignCollate`` (`dataset.py:96-132`) with an extra bucketing
    stage. With ``bucket_spec=None`` the batch is padded to its exact dynamic
    max width (the reference's); with a ``BucketSpec`` the pad width is
    rounded up to the bucket (the eval's).
    """

    def __init__(self, imgH: int = 128, PAD: str = "NormalizePAD",
                 max_width: int = 1600,
                 bucket_spec: BucketSpec | None = None):
        self.imgH = imgH
        self.PAD = PAD
        self.max_width = max_width
        self.bucket_spec = bucket_spec

    def __call__(self, batch, min_width: int = 0) -> dict:
        """``min_width``: collate as if the batch also held a line that
        wide (a row shard collated as its whole batch is)."""
        batch = [x for x in batch if x is not None]
        images, labels = zip(*batch)
        labels = list(labels)

        maxW = max(max(img.shape[1] for img in images), min_width)
        if self.max_width and maxW > self.max_width:
            maxW = self.max_width

        # Proportional label truncation for over-wide lines
        # (`dataset.py:121-128`).
        clipped = []
        for i, img in enumerate(images):
            w = img.shape[1]
            if w > maxW:
                keep_ratio = maxW / w
                chars_to_keep = max(1, int(len(labels[i]) * keep_ratio))
                labels[i] = labels[i][:chars_to_keep]
                img = img[:, :maxW]
            clipped.append(img)

        target_w = (self.bucket_spec.bucket_for(maxW)
                    if self.bucket_spec else maxW)
        arr, widths = normalize_pad_batch(clipped, target_w, pad=self.PAD)
        return {"images": arr, "widths": widths, "labels": tuple(labels)}
