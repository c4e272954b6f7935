"""Host data loader: threaded decode/resize, width-grouped batches, sharding
(the JAX package's ``data/loader.py``).

Replaces the reference's ``torch.utils.data.DataLoader`` + worker processes +
``DistributedSampler`` stack (`main.py:275-321`) with the JAX package's
design, so the port's eval sees the same batches in the same order:

  * **Width-grouped batching** (optional): items are grouped by resized width
    so batches land in the smallest possible bucket. The widths come from
    the PNG header (its IHDR chunk), with no image library; another format
    is decoded with OpenCV to learn its size.
  * **Thread-pool decode**: OpenCV releases the GIL, so threads (not
    processes) keep the host cores busy without pickling.
  * **Prefetch**: a background thread keeps ``prefetch`` collated batches
    ready while the card computes (the reference uses ``prefetch_factor=4``,
    `main.py:285-321`).
  * **Sharding**: ``shard_id/num_shards`` slice the batch list per process
    the way ``DistributedSampler`` does per rank (`main.py:280-282`), with
    ``set_epoch``-style reshuffling via the ``seed + epoch`` fold.
  * **Row shards** (``rows=(i, n)``, the data-parallel trainer's): every
    process plans the same global batches and takes rows ``[i * B / n,
    (i + 1) * B / n)`` of each, decoding only those; the shard is padded
    to its whole batch's width, which the PNG headers give, so its rows
    are the whole batch's rows.
"""

from __future__ import annotations

import queue
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .bucketing import AlignCollate

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def image_size(path: str) -> Tuple[int, int]:
    """``(width, height)`` of an image file: a PNG's from its IHDR chunk
    (big-endian at bytes 16-24), any other format's from an OpenCV decode."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == _PNG_SIGNATURE and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"{path}: not an image OpenCV decodes")
    return img.shape[1], img.shape[0]


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: AlignCollate,
        shuffle: bool = False,
        seed: int = 0,
        group_by_width: bool = False,
        num_workers: int = 8,
        prefetch: int = 4,
        shard_id: int = 0,
        num_shards: int = 1,
        drop_last: bool = True,
        rows: Tuple[int, int] = (0, 1),
    ):
        if batch_size % rows[1]:
            raise ValueError(f"batch size {batch_size} is not divisible by "
                             f"{rows[1]} row shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.group_by_width = group_by_width
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.drop_last = drop_last
        self.rows = rows
        self.epoch = 0
        self._widths: Optional[np.ndarray] = None

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch (`main.py:333-334`)."""
        self.epoch = epoch

    # ------------------------------------------------------------------ plan
    def _item_widths(self) -> np.ndarray:
        """Resized widths without decoding pixels (the PNG header)."""
        if self._widths is None:
            widths = np.zeros((len(self.dataset.data_list),), dtype=np.int64)
            h = self.dataset.img_h
            for i, (path, _) in enumerate(self.dataset.data_list):
                w0, h0 = image_size(path)
                widths[i] = int(w0 * (h / h0))
            self._widths = widths
        return self._widths

    def _batches(self) -> List[np.ndarray]:
        n = len(self.dataset)  # already truncated to a batch multiple
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.group_by_width:
            widths = self._item_widths()[: len(self.dataset.data_list)]
            jitter = rng.random(len(widths)) if self.shuffle else 0.0
            order = np.argsort(widths + jitter, kind="stable")[:n]
        elif self.shuffle:
            order = rng.permutation(len(self.dataset.data_list))[:n]
        else:
            order = np.arange(n)
        batches = [order[i: i + self.batch_size]
                   for i in range(0, n, self.batch_size)
                   if (not self.drop_last
                       or i + self.batch_size <= n)]
        if self.shuffle:
            rng.shuffle(batches)
        # Shard whole batches across processes.
        batches = batches[self.shard_id:: self.num_shards]
        return batches

    def __len__(self) -> int:
        return len(self._batches())

    # ------------------------------------------------------------------ iter
    def _load_batch(self, idxs: np.ndarray):
        i, n = self.rows
        if n == 1:
            items = list(self._pool.map(self.dataset.__getitem__, idxs))
            return self.collate_fn(items)
        width = int(self._item_widths()[idxs].max())
        s = len(idxs) // n
        items = list(self._pool.map(self.dataset.__getitem__,
                                    idxs[i * s: (i + 1) * s]))
        return self.collate_fn(items, min_width=width)

    def __iter__(self) -> Iterator[dict]:
        batches = self._batches()
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        break
                    q.put(self._load_batch(idxs))
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit.
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            self._pool.shutdown(wait=False)
