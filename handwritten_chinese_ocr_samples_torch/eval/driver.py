"""Evaluation/inference driver (the JAX package's ``eval/driver.py``, the
reference's `test.py:109-306`).

``-f`` takes the port's state dict (``cli/deploy.load_weights``: a
``torch.save``d state dict, a reference ``.pth``/``.pth.tar`` through
``compat/torch_convert.py``, or ``seed:<n>``). A classifier (``-m
innovation``) is refused: its logits are ``(B, classes)``, not CTC frames,
and the JAX driver fails on them in its decode; ``cli/train.py --test``
evaluates it. The recognizer runs in bf16, as
the JAX driver builds it; ``--int8`` runs its convs in int8, calibrated on
the first batch (``serve/quant``), and ``--lm-int8`` the LM-fused search's
LM step. Decode routes (``decode/routes``, which the
serving engine shares), as the JAX driver routes them:

  * ``greedy-search``: forward + greedy collapse on the device;
  * ``beam-search`` without an LM and without ``-ss``: the device beam
    (``decode/beam_device``, kernel K1);
  * ``beam-search -uts`` with a transformer LM, full or ``-ss``: the LM-fused
    device search (``decode/adaptive``, kernels K1-K4);
  * everything else (``-ss`` without a transformer LM, ``-kp``, ``-utp``
    alone, ``--host-beam``): the host beam over the device's f32
    log-softmax, the native decoder where it qualifies
    (``decode/beam_host_native``), else the Python one.

One batch is in flight: the next batch is dispatched before the last one's
host tail (D2H, host search, strings, CER) runs.

``-dp N`` (``args.data_parallel``): one process, N row shards of every
batch on ``parallel/mesh.data_devices(N)`` (or the ``devices`` given).
Each shard device holds one weight replica, copied once; each shard's
forward and decode run on its device from its own host thread, so that
host-bound searches overlap, and the texts come back in row order. As in
the JAX driver, N above the visible cards raises, and so does an N that
does not divide ``-b``.
"""

from __future__ import annotations

import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch

from ..parallel import mesh
from ..serve import quant


def build_beam_decoder(codec, args, device="cuda", shards=None):
    """The decoder of CLI flags: a ``decode/routes.DecodeRoute`` (the
    greedy route under ``-dm greedy-search``), with the LM of ``-tp``/``-kp``
    (``build_lm_backend``, `ctc_codec.py:101-122`). The flags map onto the
    JAX driver's routing: the LM-fused device search needs ``-uts`` with a
    transformer, so a transformer without ``-uts`` takes the host beam
    (scored when ``-kp`` is given, as the JAX driver scores it); without
    an LM, ``-utp``/``-uts`` change nothing; ``--host-beam`` forces the
    host beam. ``shards``: the devices of ``-dp``'s row shards."""
    from ..decode.lm_interface import build_lm_backend
    from ..decode.routes import build_route

    lm = None
    if args.decode_method == "beam-search":
        lm = build_lm_backend(
            tfm_path=args.tfm_path, kenlm_path=args.kenlm_path,
            use_tfm=args.use_tfm_pred or args.use_tfm_score,
            chars_list="".join(codec.chars_list))
    return build_route(
        codec, args.decode_method, lm, use_lm_pred=args.use_tfm_pred,
        use_lm_score=(args.use_tfm_score or bool(args.kenlm_path))
        and lm is not None, skip_search=args.skip_search,
        host_beam=args.host_beam or (hasattr(lm, "lm_model")
                                     and not args.use_tfm_score),
        beam_size=args.beam_size, search_depth=args.search_depth,
        lm_panelty=args.lm_panelty, len_bonus=args.len_bonus,
        prune=args.prune, lm_f32=args.lm_f32, lm_int8=args.lm_int8,
        lm_group=args.lm_group,
        lm_ctx=args.lm_ctx, seg_budget=args.seg_budget,
        run_max=args.run_max, ctx_ladder=args.ctx_ladder,
        fused_commit=args.fused_commit, device=device, shards=shards)


class EvalSession:
    """The loaded model and decode route shared by single and benchmark
    modes."""

    def __init__(self, args, devices=None):
        from ..cli.deploy import load_weights
        from ..core.codec import CTCCodec
        from ..models.registry import get_model_info

        self.args = args
        self.device = torch.device(args.device)
        self.shards = self._shard_devices(args, devices)
        input_path = args.input if os.path.isdir(args.input) else None
        model, characters = get_model_info(
            args.model_type, data_dir=input_path,
            chars_list_file=args.chars_list, dtype=torch.bfloat16)
        if model.pred != "CTC":
            raise ValueError(
                f"-m {args.model_type}: a {model.pred} model gives one class "
                "an image, not CTC frames, so this driver cannot decode it; "
                f"evaluate it with cli/train.py -m {args.model_type} --test "
                "-re <checkpoint> -d <data>")
        model.load_state_dict(load_weights(args.model_file, model))
        self.model = model.to(self.device).eval()
        self.codec = CTCCodec(characters)
        if self.shards is not None:
            # one replica a shard device, copied once
            self._replicas = {}
            for d in self.shards:
                if d not in self._replicas:
                    self._replicas[d] = (
                        self.model if d == mesh.canonical(self.device)
                        else copy.deepcopy(self.model).to(d))
            self._pool = ThreadPoolExecutor(len(self.shards),
                                            thread_name_prefix="dp-shard")
        self.route = build_beam_decoder(self.codec, args, self.device,
                                        shards=self.shards)
        # int8 conv scales (``serve/quant``), calibrated on the first batch
        self.int8 = bool(args.int8)
        self._quant = None
        if self.int8 and not quant.supports_quant(self.model):
            raise ValueError(f"--int8: model '{args.model_type}' has no "
                             f"quantized conv path")
        if self.route.name == "lm" and not args.skip_search:
            print("note: full (non-skip) LM-fused beam search is "
                  "~an order of magnitude slower than `-ss` "
                  "(skip-search, the reference's fast path) at equal "
                  "accuracy on peaky posteriors — consider adding -ss")

    @staticmethod
    def _shard_devices(args, devices):
        """``-dp``'s shard devices (None for one device), with the JAX
        driver's checks."""
        ndp = len(devices) if devices is not None else int(
            args.data_parallel or 0)
        if ndp <= 1:
            return None
        if devices is None:
            devices = mesh.data_devices(ndp, args.device)
        if args.batch_size % ndp != 0:
            raise ValueError(f"--data-parallel {ndp} must divide the batch "
                             f"size {args.batch_size}")
        return [mesh.canonical(d) for d in devices]

    def _shard_logits(self, i: int, rows: np.ndarray) -> torch.Tensor:
        """Shard ``i``'s forward on its device (run on its thread)."""
        d = self.shards[i]
        with mesh.on_shard(i, d), torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(rows)).to(
                d, non_blocking=True)
            return self._replicas[d](x)

    @torch.inference_mode()
    def decode_batch_async(self, images_nhwc: np.ndarray):
        """Dispatch a ``(B, H, W, 1)`` normalised f32 batch; returns
        ``finalize() -> (texts, seconds)``. The forward and the route's
        device work are queued at once; the host tail waits in
        ``finalize``, so a caller that dispatches the next batch first
        overlaps the two."""
        t0 = time.time()
        if self.shards is not None:
            return self._decode_shards_async(images_nhwc, t0)
        x = torch.from_numpy(np.ascontiguousarray(images_nhwc)).to(
            self.device, non_blocking=True)
        if self.int8 and self._quant is None:
            self._quant = quant.calibrate_for_model(self.model, [x])
        texts = self.route.dispatch(self.model(x))

        def finalize():
            return texts(), time.time() - t0
        return finalize

    def _decode_shards_async(self, images_nhwc: np.ndarray, t0: float):
        n = len(self.shards)
        if self.int8 and self._quant is None:
            # calibrated on the whole first batch, as without shards
            first = self._replicas[self.shards[0]]
            x = torch.from_numpy(np.ascontiguousarray(images_nhwc)).to(
                self.shards[0])
            self._quant = quant.calibrate_for_model(first, [x])
            for m in self._replicas.values():
                if m is not first:
                    quant.set_conv_amax(m, self._quant)
        logits = list(self._pool.map(
            self._shard_logits, range(n),
            [mesh.shard_rows(images_nhwc, n, i) for i in range(n)]))
        texts = self.route.dispatch_shards(logits, self._pool)

        def finalize():
            return texts(), time.time() - t0
        return finalize

    def decode_batch(self, images_nhwc: np.ndarray
                     ) -> Tuple[List[str], float]:
        """(B, H, W, 1) normalised f32 -> texts, elapsed seconds."""
        return self.decode_batch_async(images_nhwc)()


def run_single(args) -> None:
    """Single image / ad-hoc folder mode (`test.py:163-201`); the pad width
    is rounded up to a multiple of 256, as the JAX driver rounds it."""
    from ..data.bucketing import (BucketSpec, default_buckets,
                                  normalize_pad_batch)
    from ..data.dataset import read_resize_image

    session = EvalSession(args)
    h = session.model.img_height
    if os.path.isfile(args.input):
        files = [args.input]
    else:
        files = [os.path.join(args.input, f)
                 for f in sorted(os.listdir(args.input))
                 if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))]
    images = [read_resize_image(f, h) for f in files]
    max_w = max(im.shape[1] for im in images)
    spec = BucketSpec(default_buckets(
        max(256, -(-max_w // 256) * 256), step=256))
    bs = args.batch_size
    for i in range(0, len(images), bs):
        chunk = images[i: i + bs]
        maxW = spec.bucket_for(max(im.shape[1] for im in chunk))
        batch, _ = normalize_pad_batch(chunk, maxW)
        texts, dt = session.decode_batch(batch)
        print(f"max_width: {maxW}, throughput: "
              f"{dt / len(chunk) * 1000:.2f} ms/img")
        for f, t in zip(files[i: i + bs], texts):
            print(f"file:\t{f}\npred:\t{t}")


def run_benchmark(args, devices=None) -> float:
    """Test-set CER (`test.py:230-306`): prints ``Total Test CER: <cer>``
    and returns the CER. ``devices``: ``-dp``'s shard devices, given
    explicitly (e.g. two shards on one card)."""
    from ..data.bucketing import AlignCollate, BucketSpec
    from ..data.dataset import ImageDataset
    from ..data.loader import DataLoader
    from .metrics import cer_counts

    if not os.path.isdir(args.input):
        raise AssertionError("Input should be a folder under benchmark mode.")
    session = EvalSession(args, devices)
    model = session.model
    dataset = ImageDataset(args.input, (1, model.img_height), "test",
                           batch_size=args.batch_size)
    collate = AlignCollate(imgH=model.img_height, PAD=model.pad_mode,
                           bucket_spec=BucketSpec())
    loader = DataLoader(dataset, args.batch_size, collate,
                        num_workers=args.workers)

    dist_sum, len_sum, n_img = 0, 0, 0
    t_first = None  # wall clock from the first dispatch: with one batch
    # in flight the finalize intervals overlap, so the pipeline's own
    # clock is the throughput

    def consume(entry):
        nonlocal dist_sum, len_sum, n_img
        i, finalize, labels = entry
        texts, _ = finalize()
        n_img += len(texts)
        d, t = cer_counts(texts, labels)
        dist_sum += d
        len_sum += t
        if args.test_verbose:
            for p, g in zip(texts, labels):
                print(f"PRE: {p}\nTRU: {g}")
        if (i + 1) % args.print_freq == 0:
            elapsed = time.time() - t_first
            print(f"[{i + 1}/{len(loader)}] CER so far: "
                  f"{dist_sum / max(len_sum, 1):.4f} "
                  f"({elapsed / max(n_img, 1) * 1000:.1f} ms/img wall)")

    prev = None
    for i, batch in enumerate(loader):
        if t_first is None:
            t_first = time.time()
        finalize = session.decode_batch_async(batch["images"])
        if prev is not None:
            consume(prev)
        prev = (i, finalize, list(batch["labels"]))
    if prev is not None:
        consume(prev)
    elapsed = time.time() - (t_first or time.time())
    cer = dist_sum / max(len_sum, 1)
    print(f"lines: {n_img}, wall: {elapsed:.3f} s, "
          f"{n_img / max(elapsed, 1e-9):.2f} lines/s")
    print(f"Total Test CER: {cer}")
    return cer
