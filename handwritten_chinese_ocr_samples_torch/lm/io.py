"""Char-LM loading for the port (the JAX package's ``lm/io.py``).

``load_lm(spec)`` returns ``(model, state_dict, tokenizer)``; ``spec`` is

  * ``seed:<n>``: the ``char-512x6`` widths (``lm/model.get_lm_config``)
    with random weights from seed ``n`` and
    ``Tokenizer.from_characters(chars_list)``; the vocabulary size is the
    tokenizer's (7377 for the full-size 7373-character list);
  * a directory holding ``config.json``, ``dict.txt`` and ``weights.pt``, a
    torch state dict (``utils.weights.lm_flax_to_torch`` of the JAX
    package's orbax ``weights/`` tree, converted where JAX is installed), or
    instead of ``weights.pt`` the packed ``weights.pt.xz``
    (``utils.weights.load_packed``), read in f32.

``save_lm`` writes such a directory (``config.json``, ``dict.txt``,
``weights.pt``) from a model, its state dict and its tokenizer.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..utils.weights import (PACKED_SUFFIX, load_packed,
                             normalize_serving_dtype)
from .model import CharTransformerLM, get_lm_config
from .tokenizer import Tokenizer


def save_lm(out_dir: str, model: CharTransformerLM,
            state: Dict[str, torch.Tensor], tokenizer: Tokenizer) -> None:
    """Write ``out_dir/{config.json, dict.txt, weights.pt}``: the model's
    configuration (the JAX ``save_lm``'s keys), the dictionary and the
    state dict in f32 on the CPU."""
    os.makedirs(out_dir, exist_ok=True)
    tokenizer.save_dict(os.path.join(out_dir, "dict.txt"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(model.config(), f, indent=2)
    torch.save({k: v.detach().float().cpu() for k, v in state.items()},
               os.path.join(out_dir, "weights.pt"))


def load_lm(spec: str, chars_list: Optional[str] = None
            ) -> Tuple[CharTransformerLM, Dict[str, torch.Tensor], Tokenizer]:
    if spec.startswith("seed:"):
        if chars_list is None:
            raise ValueError("a seeded LM needs the recognizer's characters "
                             "(chars_list) for its tokenizer")
        from ..utils.weights import seeded_lm_state_dict
        tokenizer = Tokenizer.from_characters(chars_list)
        cfg = dict(get_lm_config("char-512x6"),
                   vocab_size=tokenizer.vocab_size)
        state = seeded_lm_state_dict(cfg, int(spec.split(":", 1)[1]))
        return CharTransformerLM(**cfg), state, tokenizer
    dict_file = os.path.join(spec, "dict.txt")
    cfg_file = os.path.join(spec, "config.json")
    weights = os.path.join(spec, "weights.pt")
    for p in (dict_file, cfg_file):
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f"{p} missing: an LM directory holds dict.txt, config.json "
                f"and weights.pt")
    packed = os.path.join(spec, "weights" + PACKED_SUFFIX)
    if not os.path.isfile(weights) and not os.path.isfile(
            packed + ".json"):
        hint = (" (it has an orbax weights/ tree: convert it first with "
                "utils.weights.lm_flax_to_torch where JAX runs, and save "
                "the result as weights.pt)"
                if os.path.isdir(os.path.join(spec, "weights")) else "")
        raise FileNotFoundError(f"{weights} (or {packed}) missing{hint}")
    tokenizer = Tokenizer(dict_file)
    with open(cfg_file) as f:
        cfg = json.load(f)
    state = (torch.load(weights, map_location="cpu", weights_only=True)
             if os.path.isfile(weights) else load_packed(packed))
    return (CharTransformerLM(**cfg), normalize_serving_dtype(state),
            tokenizer)
