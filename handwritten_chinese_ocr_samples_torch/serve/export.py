"""Model export (the JAX package's ``serve/export.py``): ``torch.export``
programs in place of its ``jax.export`` StableHLO bundles.

Each program takes the weights as an argument, as the JAX bundle's
``infer(variables, x_u8)`` does, so a bundle holds its weights once however
many buckets it has. Artifacts written to ``<out_dir>/``:

  * ``<tag>_b{B}_w{W}.pt2``: one program per (batch, width) bucket,
    ``(weights, x_u8 (B, H, W, 1) uint8) -> (chars (B, W) int32, lengths
    (B,) int32)``: normalise, forward, greedy collapse on the device;
  * ``<tag>_weights.pt``: the state dict in f32 (``torch.save``);
  * ``<tag>_meta.json``: the JAX meta's keys, plus the device the programs
    were traced on (the device is baked into a program: load its weights
    there) and the compute dtype.

The LM's bundle (``export_lm``) is the same with ``tokens (B, L) int64 ->
logits (B, L, V) f32`` programs, its dictionary and ``ExportedLMScorer``
over them.

The dtype contract is the JAX package's: weights are f32 in the bundle and
in the program's inputs, and the model's ``compute_dtype`` (``dtype`` for
the LM) sets the compute. With ``quant`` (``serve/quant``'s calibration) the
program runs the conv sites in int8 through the custom ops of
``ops/int8_conv`` (I1 on the card), each site quantizing the weight it is
given, as the JAX ``QuantizableConv`` does inside its program, with the
calibrated absmax baked in as a constant.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.decode import greedy_decode_device
from ..ops.int8_conv import QuantConv
from ..utils.weights import normalize_serving_dtype
from . import quant as quant_mod


class _Recognizer(torch.nn.Module):
    """``(weights, x_u8) -> (chars, lengths)``: the serving engine's
    normalisation, written as it writes it, ``model``'s forward over the
    given weights and the greedy collapse. The model is held outside the
    module tree, so an exported program carries no weights."""

    def __init__(self, model: torch.nn.Module, unknown_id: int):
        super().__init__()
        self._model = [model]
        self.unknown_id = unknown_id

    def forward(self, weights: Dict[str, torch.Tensor], x_u8: torch.Tensor):
        x = (x_u8.float() - 127.5) / 127.5
        logits = torch.func.functional_call(self._model[0], weights, (x,),
                                            strict=True)
        return greedy_decode_device(logits, None, unknown_id=self.unknown_id)


class _LMLogits(torch.nn.Module):
    """``(weights, tokens) -> logits``, the LM's forward over the given
    weights; the model is held outside the module tree."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self._model = [model]

    def forward(self, weights: Dict[str, torch.Tensor], tokens: torch.Tensor):
        return torch.func.functional_call(self._model[0], weights,
                                          (tokens,), strict=True)


class _TracedQuantConv:
    """A conv site's int8 state, rebuilt at each call from the weight the
    site holds then (the program's input under ``functional_call``) and the
    calibrated absmax."""

    def __init__(self, conv, amax: float):
        self.conv, self.amax = conv, amax

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return QuantConv(self.conv.weight, self.conv.bias, self.amax)(x)


def _export(program: torch.nn.Module, args, path: str) -> None:
    ep = torch.export.export(program, args)
    # the example inputs would carry the weights into every file
    ep._example_inputs = None
    torch.export.save(ep, path)


def _save_weights(weights: Dict[str, torch.Tensor], path: str) -> None:
    torch.save({k: v.detach().cpu() for k, v in weights.items()}, path)


def _prepare(model, state, out_dir: str, device):
    """The weights in f32 on ``device``, loaded into ``model`` there in
    eval mode; ``out_dir`` made."""
    weights = {k: v.to(device)
               for k, v in normalize_serving_dtype(state).items()}
    model.load_state_dict(weights)
    model.to(device).eval()
    os.makedirs(out_dir, exist_ok=True)
    return weights


def load_weights(path: str, device: str | torch.device
                 ) -> Dict[str, torch.Tensor]:
    """A bundle's ``<tag>_weights.pt`` on ``device``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device) for k, v in state.items()}


def export_model(model, state, out_dir: str, tag: str = "hctr",
                 widths: Sequence[int] = (512, 1024, 1600),
                 batch_sizes: Sequence[int] = (1,),
                 unknown_id: int | None = None,
                 quant: Dict[str, float] | None = None,
                 device: str | torch.device = "cuda") -> dict:
    """Write the recognizer's bundle for every (batch, width) bucket;
    returns the meta. ``model`` (an ``HCTRModel``) is traced on ``device``
    in its ``compute_dtype`` and left in eval mode there; ``quant`` maps
    each conv site to its calibrated input absmax. Any int8 state the
    model's sites held is restored after."""
    device = torch.device(device)
    weights = _prepare(model, state, out_dir, device)
    if unknown_id is None:
        unknown_id = model.num_classes - 1
    sites = quant_mod.conv_sites(model)
    saved = {name: m.int8 for name, m in sites.items()}
    program = _Recognizer(model, unknown_id)
    h = model.img_height
    artifacts: List[str] = []
    try:
        if quant is not None:
            quant_mod.set_conv_amax(model, quant)  # checks the site names
            for name, m in sites.items():
                m.int8 = _TracedQuantConv(m, quant[name])
        for b in batch_sizes:
            for w in widths:
                x = torch.zeros((b, h, w, 1), dtype=torch.uint8,
                                device=device)
                name = f"{tag}_b{b}_w{w}.pt2"
                _export(program, (weights, x),
                        os.path.join(out_dir, name))
                artifacts.append(name)
    finally:
        for name, m in sites.items():
            m.int8 = saved[name]
    _save_weights(weights, os.path.join(out_dir, f"{tag}_weights.pt"))
    meta = {
        "tag": tag,
        "img_height": h,
        "num_classes": model.num_classes,
        "widths": list(widths),
        "batch_sizes": list(batch_sizes),
        "artifacts": artifacts,
        "weights": f"{tag}_weights.pt",
        "input": "uint8 NHWC grayscale, raw pixels (normalization is fused)",
        "output": "compact collapsed char indices + lengths",
        "int8": quant is not None,
        "device": str(device),
        "compute_dtype": str(model.compute_dtype).replace("torch.", ""),
    }
    with open(os.path.join(out_dir, f"{tag}_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def load_exported(path: str):
    """A ``.pt2`` program as a callable ``fn(weights, x)``. Importing this
    module has registered the custom ops an int8 program calls."""
    return torch.export.load(path).module()


# ----------------------------------------------------------------- LM export
def export_lm(model, state, tokenizer, out_dir: str, tag: str = "lm",
              batch_sizes: Sequence[int] = (1, 10),
              lengths: Sequence[int] = (32, 64),
              device: str | torch.device = "cuda") -> dict:
    """Write the char LM's bundle: one program per (batch, length) bucket
    computing ``tokens (B, L) int64 -> logits (B, L, V) f32`` in the
    model's dtype, the dictionary, the weights once, and the meta."""
    device = torch.device(device)
    weights = _prepare(model, state, out_dir, device)
    program = _LMLogits(model)
    artifacts: List[str] = []
    for b in batch_sizes:
        for L in lengths:
            tokens = torch.zeros((b, L), dtype=torch.int64, device=device)
            name = f"{tag}_b{b}_l{L}.pt2"
            _export(program, (weights, tokens), os.path.join(out_dir, name))
            artifacts.append(name)
    tokenizer.save_dict(os.path.join(out_dir, f"{tag}_dict.txt"))
    _save_weights(weights, os.path.join(out_dir, f"{tag}_weights.pt"))
    meta = {
        "tag": tag,
        "vocab_size": model.vocab_size,
        "max_len": model.max_len,
        "batch_sizes": list(batch_sizes),
        "lengths": list(lengths),
        "artifacts": artifacts,
        "weights": f"{tag}_weights.pt",
        "dict": f"{tag}_dict.txt",
        "output": "next-token logits (B, L, V); position t scores token t+1",
        "device": str(device),
        "dtype": str(model.dtype).replace("torch.", ""),
    }
    with open(os.path.join(out_dir, f"{tag}_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class ExportedLMScorer:
    """``score`` / ``next_k_words`` over an exported LM bundle, with the JAX
    ``ExportedLMScorer``'s rules: a request is padded up to the smallest
    (batch, length) bucket that holds it (the largest if none does);
    sentences longer than the largest length score their truncated prefix,
    and predict the next word from the last position in the bucket. The
    programs run on the device they were traced on."""

    def __init__(self, lm_dir: str, tag: str = "lm"):
        from ..lm.tokenizer import Tokenizer

        with open(os.path.join(lm_dir, f"{tag}_meta.json")) as f:
            self.meta = json.load(f)
        self.device = torch.device(self.meta["device"])
        self.tokenizer = Tokenizer(os.path.join(lm_dir, self.meta["dict"]))
        self.weights = load_weights(
            os.path.join(lm_dir, self.meta["weights"]), self.device)
        self._fns = {
            (b, L): load_exported(os.path.join(lm_dir,
                                               f"{tag}_b{b}_l{L}.pt2"))
            for b in self.meta["batch_sizes"] for L in self.meta["lengths"]}

    def _bucket(self, n: int, need_len: int):
        bs = [b for b in sorted(self.meta["batch_sizes"]) if b >= n]
        ls = [L for L in sorted(self.meta["lengths"]) if L >= need_len]
        b = bs[0] if bs else max(self.meta["batch_sizes"])
        L = ls[0] if ls else max(self.meta["lengths"])
        return b, L

    @torch.inference_mode()
    def _logits(self, sentences, char_based):
        need = max(len(s) for s in sentences) + 2
        b, L = self._bucket(len(sentences), need)
        out = []
        for i in range(0, len(sentences), b):
            chunk = sentences[i: i + b]
            pad = b - len(chunk)
            ids = self.tokenizer.tokenize(chunk + [""] * pad,
                                          char_based=char_based,
                                          fixed_len=L)
            logits = self._fns[(b, L)](
                self.weights, torch.from_numpy(ids).to(self.device))
            out.append(logits[: len(chunk)].cpu().numpy())
        return np.concatenate(out, axis=0)

    def score(self, sentences, char_based: bool = False) -> np.ndarray:
        if not sentences:
            return np.zeros((0,))
        from scipy.special import logsumexp
        logits = self._logits(sentences, char_based)     # (B, L, V)
        lse = logsumexp(logits, axis=-1)                 # (B, L)
        out = np.zeros((len(sentences),))
        for i, s in enumerate(sentences):
            # the fixed-shape contract: a sentence past the bucket scores
            # the prefix the bucket holds
            n = min(len(s), logits.shape[1] - 2)
            toks = self.tokenizer.tokenize([s], char_based=char_based,
                                           fixed_len=logits.shape[1])[0]
            for t in range(n):
                out[i] += logits[i, t, toks[t + 1]] - lse[i, t]
        return out

    def next_k_words(self, sentences, k: int, char_based: bool = False):
        if not sentences:
            return []
        logits = self._logits(sentences, char_based)
        res = []
        for i, s in enumerate(sentences):
            # an over-long prefix predicts from the last in-bucket position
            at = logits[i, min(len(s), logits.shape[1] - 1)]
            idx = np.argsort(-at, kind="stable")[:k]
            res.append(self.tokenizer.decode(idx))
        return res
