"""Model registry keyed by model tag (the JAX package's ``models/registry.py``).

``hctr`` is the full-width recognizer (512 channels, blocks [2, 4, 5, 1],
53.1M parameters at 7375 classes); ``hctr-tiny`` is the same topology at 64
channels and blocks [1, 1, 1, 1], used by the tests; ``innovation`` is the
isolated-character classifier (``models/innovation.py``: the same trunk
with 2x2 pooling and a 512 -> ``num_classes`` head, 41.8M parameters at
7375 classes).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from ..core.codec import load_chars_list
from .hctr import HCTRModel, hctr_model
from .innovation import innovation_model


def _hctr_tiny(num_classes: int, compute_dtype: torch.dtype,
               **kwargs) -> HCTRModel:
    return HCTRModel(num_classes=num_classes, backbone_channels=64,
                     num_blocks=(1, 1, 1, 1), compute_dtype=compute_dtype,
                     **kwargs)


_REGISTRY = {"hctr": hctr_model, "hctr-tiny": _hctr_tiny,
             "innovation": innovation_model}


def list_models():
    return sorted(_REGISTRY)


def discover_chars_list(input_path: str | None = None) -> str:
    """Locate ``chars_list.txt`` next to / above a dataset path, in the JAX
    package's discovery order."""
    candidates = []
    if input_path:
        parent = os.path.dirname(input_path.rstrip("/"))
        candidates.append(os.path.join(parent, "chars_list.txt"))
        candidates.append(os.path.join(input_path, "chars_list.txt"))
    candidates += [
        "./data/handwritten_ctr_data/chars_list.txt",
        "./data/hwdb2.0/chars_list.txt",
        "./data/demo_data/chars_list.txt",
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"chars_list.txt not found near {input_path!r} (tried {candidates})")


def get_model_info(model_type: str, data_dir: str | None = None,
                   chars_list_file: str | None = None,
                   dtype: torch.dtype = torch.float32, **kwargs
                   ) -> Tuple[torch.nn.Module, str]:
    """Resolve ``(model, characters)`` for a model tag; ``dtype`` is the
    compute dtype, ``kwargs`` the model's own fields (``stage_drop``,
    ``block_drop``, ``remat``; ``innovation``'s ``use_multiscale``,
    ``use_spatial_attn``, ``head_drop``). ``num_classes = 1 (blank) +
    len(characters) + 1 (unknown)``. The model holds PyTorch's default
    initialisation until a state dict is loaded."""
    if model_type not in _REGISTRY:
        raise ValueError(f"Model type: {model_type} not supported "
                         f"(available: {list_models()})")
    if chars_list_file is None:
        in_dir = os.path.join(data_dir or "", "chars_list.txt")
        chars_list_file = (in_dir if data_dir and os.path.isfile(in_dir)
                           else discover_chars_list(data_dir))
    characters = load_chars_list(chars_list_file)
    model = _REGISTRY[model_type](num_classes=len(characters) + 2,
                                  compute_dtype=dtype, **kwargs)
    return model, characters
