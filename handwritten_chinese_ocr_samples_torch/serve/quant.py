"""Post-training int8 quantization for the serving and eval forward (the JAX
package's ``serve/quant.py``).

Scheme (``models/hctr.Conv`` with its ``ops/int8_conv.QuantConv`` state):

  * a symmetric per-tensor activation scale ``s_x = amax / 127`` from one
    calibration pass (this module);
  * symmetric per-out-channel weight scales from the f32 weight, when the
    state is put on;
  * s32 accumulation (kernel I1 on the card), dequantisation and bias in
    f32, then the compute dtype. BatchNorm, SE, the residual and the CTC
    head stay float.

Calibration is one float eval forward a batch: a hook on every ``Conv``
takes the absmax of its input in the compute dtype, as f32, and the
maximum over the batches. Sites are keyed by module path
(``cnn.block1_0.down_conv``); ``utils/weights.quant_flax_to_torch`` gives
the JAX package's nested tree the same keys.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..models.hctr import Conv


def calibration_images(folder: str, height: int, width: int,
                       n: int = 16) -> np.ndarray:
    """The first ``n`` line images of ``folder``, by file name, padded to
    ``width``: ``(n, height, width, 1)`` uint8. This is the calibration
    batch of ``cli/export.py --int8-calib``, as the JAX CLI reads it."""
    from .engine import preprocess_fixed_shape
    files = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    if not files:
        raise ValueError(f"no images in {folder}")
    return np.concatenate([
        preprocess_fixed_shape(os.path.join(folder, f), height, width)
        for f in files[:n]], axis=0)


def conv_sites(model: torch.nn.Module) -> Dict[str, Conv]:
    """The model's conv sites by module path."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Conv)}


@torch.inference_mode()
def calibrate_conv_amax(model: torch.nn.Module,
                        batches: Iterable[torch.Tensor]) -> Dict[str, float]:
    """Float eval forwards over ``batches``; returns each conv site's input
    absmax (f32 values), the maximum over the batches. Sites that carry an
    int8 state run float meanwhile, and get it back after."""
    sites = conv_sites(model)
    acc: Dict[str, torch.Tensor] = {}

    def hook(name):
        def record(_module, inputs):
            a = inputs[0].abs().amax().float()
            acc[name] = a if name not in acc else torch.maximum(acc[name], a)
        return record

    saved = {name: m.int8 for name, m in sites.items()}
    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in sites.items()]
    training = model.training
    model.eval()
    n = 0
    try:
        for m in sites.values():
            m.int8 = None
        for x in batches:
            model(x)
            n += 1
    finally:
        for h in handles:
            h.remove()
        for name, m in sites.items():
            m.int8 = saved[name]
        model.train(training)
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return {name: float(a) for name, a in acc.items()}


def conv_site_count(amax: Dict[str, float]) -> int:
    """Number of quantized conv sites in a calibration."""
    return len(amax)


def supports_quant(model: torch.nn.Module) -> bool:
    """Whether the model has conv sites that can run in int8."""
    return bool(conv_sites(model))


def set_conv_amax(model: torch.nn.Module,
                  amax: Optional[Dict[str, float]]) -> None:
    """Put the int8 state of ``amax`` on the model's conv sites (each from
    its f32 weight, on the weight's device), or take every site's off
    (``amax`` None). A site of the model that ``amax`` lacks, or a key that
    names no site, raises."""
    sites = conv_sites(model)
    if amax is None:
        for m in sites.values():
            m.set_amax(None)
        return
    if set(amax) != set(sites):
        raise KeyError(f"calibration and model differ in conv sites: "
                       f"{sorted(set(amax) ^ set(sites))}")
    for name, m in sites.items():
        m.set_amax(amax[name])


def calibrate_for_model(model: torch.nn.Module, batches,
                        announce: bool = True) -> Dict[str, float]:
    """The calibration every int8 entry point uses (serving engine, eval
    driver): raises for a model without conv sites, calibrates, puts the
    int8 state on the model's sites and prints the standard one-liner.
    Returns the calibration."""
    if not supports_quant(model):
        raise ValueError(f"int8: model {type(model).__name__} has no "
                         f"quantized conv path (no Conv sites)")
    amax = calibrate_conv_amax(model, batches)
    set_conv_amax(model, amax)
    if announce:
        print(f"[int8] calibrated {conv_site_count(amax)} conv sites; "
              f"serving s8xs8->s32 convs")
    return amax
