"""The port's state dict in the reference's ``.pth`` layout: the inverse of
``compat/torch_convert.convert_state_dict``, for building reference
checkpoints from the port's weights. The port reads such files and never
writes them; ``chip_smoke.py``'s ``pth`` phase and the tests share this.

Torch and the standard library only, as ``chip_smoke.py`` runs it on the
card's machine.
"""

from __future__ import annotations

import re
from typing import Dict, List

import torch

from handwritten_chinese_ocr_samples_torch.compat.torch_convert import (
    HEAD_HEIGHT)


def _reference_prefix(path: List[str]) -> List[str]:
    out = []
    for p in path:
        m = re.fullmatch(r"block(\d)_(\d+)", p)
        t = re.fullmatch(r"transform(\d+)_(conv|bn)", p)
        if m:
            out += [f"block{m.group(1)}", m.group(2)]
        elif p in ("down_conv", "down_bn"):
            out += ["downsample", "0" if p == "down_conv" else "1"]
        elif t:
            out += ["transforms", t.group(1),
                    "0" if t.group(2) == "conv" else "1"]
        elif p in ("fusion_conv", "fusion_bn"):
            out += ["fusion", "0" if p == "fusion_conv" else "1"]
        elif p in ("fc1", "fc2") and out[-1:] == ["se"]:
            out += ["fc", "0" if p == "fc1" else "2"]
        else:
            out.append(p)
    return out


def reference_state_dict(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The port's state dict -> the reference's layout (with a
    ``num_batches_tracked`` beside each BatchNorm's statistics)."""
    out = {}
    for key, v in state.items():
        *mod, leaf = key.split(".")
        ref = ".".join(_reference_prefix(mod) + [leaf])
        if leaf == "weight" and v.ndim == 2 and mod[-1:] == ["linear"]:
            o, hc = v.shape
            v = (v.reshape(o, HEAD_HEIGHT, hc // HEAD_HEIGHT)
                 .transpose(1, 2).reshape(o, hc))
        out[ref] = v.contiguous()
        if leaf == "running_var":
            out[ref.rsplit(".", 1)[0] + ".num_batches_tracked"] = (
                torch.tensor(0))
    return out
