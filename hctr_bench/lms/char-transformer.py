"""LM plug-in: the char transformer (the port's ``lm/model.py``
``CharTransformerLM``, served through ``decode/lm_interface.py``
``TorchLMBackend``), a pre-norm decoder with learned positions, LayerNorm
and a tied head; the fusion LM of ``hctr-bf16``.

An LM plug-in is the one file that knows its architecture. The harness
finds it by the configuration's ``lm.arch`` (``lms/<arch>.py``; this file
where it names none) and calls nothing else LM-specific:

  * ``load_state(lm_cfg, device)``: the state dict that both the program
    and the reference get;
  * ``program_lm(lm_cfg, state, device)``: the port's LM for
    ``ServingEngine(lm=...)``; the port is imported here alone;
  * ``reference_lm(lm_cfg, state, device)``: the plain reference LM, with
    ``reference.LMSearch``'s interface (``index``, ``tokens(text)``,
    ``score(texts)``);
  * ``token_flops(lm_cfg, context)``: the matrix FLOPs of one token at
    ``context`` cached positions, for ``mfu`` readers;
  * ``bounds``: kernel bounds (``name -> function`` giving ``(ms, bound
    by)``, as ``roofline.bound_ms``) of kernels that only this LM runs.

``lm_cfg`` is the configuration's ``lm`` block; its ``weights`` names a
state dict's file, or gives ``{"seed": n}`` to draw the weights on the
device (``assets.seeded_state``) at the widths of its ``config``.
"""

from __future__ import annotations

import math

import torch

import assets
import reference as ref
import roofline

bounds: dict = {}


def specs(cfg: dict) -> dict:
    """``name -> (shape, init)`` of the state dict at ``cfg``'s widths,
    after the port's seeded LM (``utils/weights.seeded_lm_state_dict``):
    matrices ~ N(0, 1/fan_in), the embedding ~ N(0, 1/d), positions ~
    N(0, 0.02^2), biases 0, LayerNorms at identity."""
    d, ff, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    out = {"embed.weight": ((V, d), 1 / math.sqrt(d)),
           "pos_embed": ((cfg["max_len"], d), 0.02)}

    def dense(name, n_out, n_in):
        out[f"{name}.weight"] = ((n_out, n_in), 1 / math.sqrt(n_in))
        out[f"{name}.bias"] = ((n_out,), "zeros")

    def norm(name):
        out[f"{name}.weight"] = ((d,), "ones")
        out[f"{name}.bias"] = ((d,), "zeros")

    for i in range(cfg["n_layers"]):
        p = f"layer{i}"
        norm(f"{p}.ln1")
        for n in ("query", "key", "value", "out"):
            dense(f"{p}.attn.{n}", d, d)
        norm(f"{p}.ln2")
        dense(f"{p}.ff1", ff, d)
        dense(f"{p}.ff2", d, ff)
    norm("ln_f")
    return out


def load_state(lm_cfg: dict, device) -> dict:
    """A file's state dict in f32 on the host, or one drawn from the seed
    on ``device`` in the LM's serving dtype."""
    weights = lm_cfg["weights"]
    if isinstance(weights, dict):
        return assets.seeded_state(specs(lm_cfg["config"]), weights["seed"],
                                   device, getattr(torch, lm_cfg["dtype"]))
    return assets.load_state(weights)


def program_lm(lm_cfg: dict, state: dict, device):
    from handwritten_chinese_ocr_samples_torch.decode.lm_interface import (
        TorchLMBackend)
    from handwritten_chinese_ocr_samples_torch.lm.model import (
        CharTransformerLM)
    from handwritten_chinese_ocr_samples_torch.lm.tokenizer import Tokenizer
    return TorchLMBackend(CharTransformerLM(**lm_cfg["config"]), state,
                          Tokenizer(assets.repo_path(lm_cfg["dict"])),
                          device=device)


def reference_lm(lm_cfg: dict, state: dict, device) -> ref.CharLM:
    return ref.CharLM(state, lm_cfg["config"],
                      assets.read_lm_dict(lm_cfg["dict"]), device)


def token_flops(lm_cfg: dict, context: float) -> float:
    c = lm_cfg["config"]
    return roofline.lm_token_flops(context, c["d_model"], c["n_layers"],
                                   c["d_ff"], c["vocab_size"])
