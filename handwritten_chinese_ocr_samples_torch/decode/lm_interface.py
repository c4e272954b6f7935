"""Language-model backends for beam-search fusion (the JAX package's
``decode/lm_interface.py``, transformer only).

``TorchLMBackend`` holds the char transformer the LM-fused device search
runs: ``lm_model`` (a ``lm/model.CharTransformerLM``), ``lm_params`` (its
state dict) and ``tokenizer``. The serving engine tells a transformer LM
apart by ``hasattr(lm, "lm_model")``, as the JAX engine does. The host
scorer (``lm/infer.LMScorer``), the KenLM n-gram backend and the host beam
that uses them are later work (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class TorchLMBackend:
    def __init__(self, lm_model, lm_params: Dict[str, torch.Tensor],
                 tokenizer):
        self.lm_model = lm_model
        self.lm_params = lm_params
        self.tokenizer = tokenizer


def build_lm_backend(tfm_path: str = "", use_tfm: bool = False,
                     chars_list: Optional[str] = None
                     ) -> Optional[TorchLMBackend]:
    """The transformer backend of CLI-style flags: ``tfm_path`` is an LM
    directory or ``seed:<n>`` (``lm/io.load_lm``; a seeded LM takes its
    vocabulary from ``chars_list``). None when no LM is asked for."""
    if not (use_tfm and tfm_path):
        return None
    from ..lm.io import load_lm
    return TorchLMBackend(*load_lm(tfm_path, chars_list=chars_list))
