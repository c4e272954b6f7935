"""The system under test: the port (``handwritten_chinese_ocr_samples_torch``)
built for one cell from the weights the benchmark loaded, and the few
places where the benchmark wraps it to record what it produced.

This is the only module of the benchmark that imports the port (beside
the port's LM that an LM plug-in's ``program_lm`` builds). It reads the
port's launch counters, the counters that metrics declare and the port's
spans, and hands the port the same inputs that the reference gets.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import time
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

PORT = "handwritten_chinese_ocr_samples_torch"


class Recorder:
    """Stands in for the engine's model: calls it, and keeps the trunk's
    output (the features the CTC head reads) of the first row that holds
    each line it watches: what the timed path's forward produced for the
    lines the check samples. A row is matched by a fingerprint of its
    pixels, and the features are kept in buffers on the card, all without
    waiting for it; ``found`` reads them once the window has closed. With
    ``timed`` it also brackets every call with CUDA events (the forward's
    device time)."""

    def __init__(self, model):
        self.model = model
        self.img_height = model.img_height
        self.groups: Dict[int, dict] = {}   # width -> the lines watched
        self.timed = False
        self.events: List[tuple] = []
        self.shapes: List[tuple] = []
        self._feats = None
        self._weights: Dict[tuple, torch.Tensor] = {}
        model.cnn.register_forward_hook(self._keep_feats)

    def _keep_feats(self, _module, _args, out):
        self._feats = out

    def __getattr__(self, name):
        return getattr(self.model, name)

    def fingerprint(self, u8: torch.Tensor) -> torch.Tensor:
        """``(B, H, W)`` uint8 rows -> ``(B,)`` int64: each row's pixels
        summed against fixed integer weights (exact)."""
        key = (tuple(u8.shape[1:]), u8.device)
        if key not in self._weights:
            g = torch.Generator().manual_seed(0)
            self._weights[key] = torch.randint(
                1, 2 ** 20, u8.shape[1:], generator=g).to(u8.device)
        return (u8.long() * self._weights[key]).flatten(1).sum(1)

    def watch(self, lines: Dict[int, torch.Tensor]) -> None:
        """Watch ``line -> (H, W) uint8 pixels as the engine pads them``
        (none: watch nothing)."""
        by_width: Dict[int, list] = {}
        for line, px in lines.items():
            by_width.setdefault(int(px.shape[-1]), []).append((line, px))
        self.groups = {}
        for w, items in by_width.items():
            px = torch.stack([p for _, p in items])
            self.groups[w] = {"lines": [line for line, _ in items],
                              "prints": self.fingerprint(px),
                              "found": torch.zeros(len(items), dtype=torch.bool,
                                                   device=px.device),
                              "feats": None}

    def found(self) -> Dict[int, torch.Tensor]:
        """``line -> its features`` (on the host) of the watched lines that
        some row held."""
        out = {}
        for g in self.groups.values():
            if g["feats"] is None:
                continue
            hit = g["found"].cpu().tolist()
            feats = g["feats"].cpu()
            out.update({line: feats[k] for k, line in enumerate(g["lines"])
                        if hit[k]})
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.shapes.append((int(x.shape[0]), int(x.shape[2])))
        if self.timed:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        y = self.model(x)
        if self.timed:
            stop.record()
            self.events.append((start, stop))
        g = self.groups.get(int(x.shape[2]))
        if g is not None and self._feats is not None:
            self._keep(g, x, self._feats)
        self._feats = None
        return y

    def _keep(self, g: dict, x: torch.Tensor, feats: torch.Tensor) -> None:
        u8 = torch.round(x[..., 0] * 127.5 + 127.5).to(torch.uint8)
        hit = self.fingerprint(u8)[:, None] == g["prints"][None, :]
        first = hit.to(torch.uint8).argmax(0)             # first row a line
        held = hit.any(0)
        take = (held & ~g["found"]).view(-1, *[1] * (feats.dim() - 1))
        if g["feats"] is None:
            g["feats"] = torch.zeros((len(g["lines"]), *feats.shape[1:]),
                                     dtype=feats.dtype, device=feats.device)
        torch.where(take, feats.index_select(0, first), g["feats"],
                    out=g["feats"])
        g["found"] |= held

    def forward_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.events]


def launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters: K1-K4 and I1 (conv, quantize)."""
    from handwritten_chinese_ocr_samples_torch.ops import (
        cache_gather, int8_conv, logits_lse, peek_attention,
        topk_logsoftmax)
    return {"k1": topk_logsoftmax.launches,
            "k2": peek_attention.launches, "k3": logits_lse.launches,
            "k4": cache_gather.launches,
            "i1_conv": sum(int8_conv.launches_by_route.values()),
            "i1_quantize": int8_conv.quantize_launches}


def read_counters(paths: Dict[str, str]) -> Dict[str, Any]:
    """``name -> value`` of the port's counters named ``name ->
    "<module>:<attribute>"``, the module given whole or relative to the
    port (``.decode.beam_lm_device:segment_steps``)."""
    out = {}
    for name, path in paths.items():
        module, sep, attr = path.partition(":")
        full = importlib.util.resolve_name(module, PORT) if sep else ""
        if full.split(".")[0] != PORT or not attr:
            raise ValueError(f"counter {name!r}: {path!r} is not "
                             f"'<module of {PORT}>:<attribute>'")
        out[name] = getattr(importlib.import_module(full), attr)
    return out


def profiling():
    """The port's spans (``utils/profiling``)."""
    from handwritten_chinese_ocr_samples_torch.utils import profiling as mod
    return mod


@contextlib.contextmanager
def program_spans(on: bool) -> Iterator[list]:
    """Keeps the port's spans while the block runs (nothing with ``on``
    false): yields a list that holds them, ``SpanRecord``s in the order
    they ended, once the block has run."""
    records: list = []
    if not on:
        yield records
        return
    prof = profiling()
    prof.enable(True)
    prof.collect()
    try:
        yield records
    finally:
        prof.enable(False)
        records.extend(prof.collect())


def build_engine(config: dict, traffic: dict, state, lm, lm_state,
                 chars_file, device, int8: bool = False,
                 lm_int8: bool = False):
    """The cell's ``ServingEngine``; on the LM route its LM is the one that
    ``lm``, the configuration's LM plug-in, builds from ``lm_state``.
    ``int8`` and ``lm_int8`` switch on the program's int8 recognizer and
    int8 LM step, the next lower precision of a bf16 configuration (its
    control)."""
    from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
    from handwritten_chinese_ocr_samples_torch.models.registry import (
        get_model_info)
    from handwritten_chinese_ocr_samples_torch.serve.engine import (
        ServingEngine)
    dtype = getattr(torch, config["compute_dtype"])
    model, chars = get_model_info(config["model"], chars_list_file=chars_file,
                                  dtype=dtype)
    kw = dict(widths=tuple(config["widths"]),
              int8=bool(config["int8"]) or int8)
    if traffic["route"] == "ss":
        lmc = config["lm"]
        if lmc["dtype"] not in ("bfloat16", "float32"):
            raise ValueError(f"the route serves its LM in bfloat16 or "
                             f"float32, not {lmc['dtype']}")
        kw.update(decode_method="beam-search",
                  lm=lm.program_lm(lmc, lm_state, device), use_lm_pred=True,
                  use_lm_score=True, skip_search=True,
                  beam_size=lmc["beam_size"],
                  search_depth=lmc["search_depth"],
                  lm_panelty=lmc["lm_panelty"], len_bonus=lmc["len_bonus"],
                  prune=lmc["prune"], lm_ctx=lmc["lm_ctx"],
                  seg_budget=lmc["seg_budget"], lm_group=traffic["lm_group"],
                  lm_f32=lmc["dtype"] == "float32", lm_int8=lm_int8)
    engine = ServingEngine(model, state, CTCCodec("".join(chars)),
                           device=device, **kw)
    return engine


def pad_for_engine(engine, images: List[np.ndarray], width: int
                   ) -> np.ndarray:
    """``images`` as one ``(n, H, width, 1)`` uint8 batch, each padded by
    the engine's own rule."""
    from handwritten_chinese_ocr_samples_torch.serve.engine import (
        _pad_fixed_shape)
    return np.concatenate([_pad_fixed_shape(a, engine.model.img_height,
                                            width) for a in images])


class DaemonTap:
    """Wraps a ``ServingDaemon``'s flush: keeps each flush's futures (its
    rows, in order), its real lines and its service time (dispatch to
    texts)."""

    def __init__(self, daemon):
        self.flushes: List[list] = []
        self.fills: List[int] = []
        self.service_s: List[float] = []
        self._orig = daemon._dispatch
        daemon._dispatch = self

    def __call__(self, items):
        t0 = time.perf_counter()
        self._orig(items)
        self.service_s.append(time.perf_counter() - t0)
        self.flushes.append([fut for _, _, fut in items])
        self.fills.append(len(items))


def make_daemon(engine, traffic: dict):
    from handwritten_chinese_ocr_samples_torch.serve.daemon import (
        ServingDaemon)
    return ServingDaemon(engine, batch_size=traffic["batch_size"],
                         max_delay_ms=traffic["max_delay_ms"])
