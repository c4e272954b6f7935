"""Weights for the port: the flax -> torch bridge and seeded weights.

``flax_to_torch`` takes the JAX package's ``{"params", "batch_stats"}`` tree
as nested dicts of numpy arrays (however the caller read it) and returns a
``state_dict`` for ``models/hctr.HCTRModel``:

  * conv kernels ``(kh, kw, I, O)`` -> ``(O, I, kh, kw)``;
  * dense kernels ``(I, O)`` -> ``(O, I)`` (the SE FCs have no bias);
  * BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) ->
    ``weight/bias/running_mean/running_var``;
  * every floating leaf, bf16 (ml_dtypes) included, is upcast to f32, the
    serving dtype contract of the JAX package's ``utils/ckpt_io.py:35-62``.

``seeded_state_dict`` makes full-size random weights from a seed, the only
way to get weights onto a machine that cannot read the orbax checkpoints.

``init_state_dict`` is the start of a training run from scratch: flax's
default initialisers, drawn from a ``torch.Generator``.

``lm_flax_to_torch`` and ``seeded_lm_state_dict`` do the same for the char
LM (``lm/model.CharTransformerLM``): flax attention kernels ``(d, H, Dh)``
become ``nn.Linear`` weights ``(H*Dh, d)``, the output kernel ``(H, Dh, d)``
becomes ``(d, H*Dh)``, and ``embed/embedding`` ``(V, d)`` is the tied head.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_NAMES = {"scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _to_f32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` numpy tree -> torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables.get("params", {})):
        a = _to_f32(leaf)
        *mod, name = path
        if name == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"unexpected kernel rank at {path}: {a.shape}")
            name = "weight"
        elif name in _PARAM_NAMES:
            name = _PARAM_NAMES[name]
        else:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        out[".".join([*mod, name])] = torch.from_numpy(np.ascontiguousarray(a))
    for path, leaf in _walk(variables.get("batch_stats", {})):
        *mod, name = path
        if name not in _STAT_NAMES:
            raise ValueError(f"unexpected batch statistic {'/'.join(path)}")
        out[".".join([*mod, _STAT_NAMES[name]])] = torch.from_numpy(
            np.ascontiguousarray(_to_f32(leaf)))
    return out


def seeded_state_dict(model: torch.nn.Module,
                      seed: int) -> Dict[str, torch.Tensor]:
    """Random f32 weights for ``model`` from a ``torch.Generator`` seed:
    conv and dense weights ~ N(0, 1/fan_in) (flax's lecun-normal default),
    biases 0, BatchNorm at identity (weight 1, bias 0, mean 0, var 1)."""
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    for key, t in model.state_dict().items():
        name = key.rsplit(".", 1)[-1]
        if name == "weight" and t.dim() >= 2:
            out[key] = torch.randn(t.shape, generator=g) / math.sqrt(
                t[0].numel())
        elif name in ("weight", "running_var"):
            out[key] = torch.ones(t.shape)
        else:
            out[key] = torch.zeros(t.shape)
    return out


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal")
# draws N(0, 1) cut at +-2 and scales it by sqrt(1 / fan_in) over the cut
# normal's standard deviation
_TRUNC_STD = 0.87962566103423978


def init_state_dict(model: torch.nn.Module,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """flax's default initialisation of ``model`` in f32: conv and dense
    kernels lecun-normal (a normal truncated at two standard deviations,
    std ``sqrt(1 / fan_in) / 0.8796``), biases 0, BatchNorm scale 1 and
    bias 0, running mean 0 and running variance 1."""
    out = {}
    for key, t in model.state_dict().items():
        name = key.rsplit(".", 1)[-1]
        if name == "weight" and t.dim() >= 2:
            std = math.sqrt(1.0 / t[0].numel()) / _TRUNC_STD
            w = torch.empty(t.shape)
            torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                        generator=generator)
            out[key] = w
        elif name in ("weight", "running_var"):
            out[key] = torch.ones(t.shape)
        else:
            out[key] = torch.zeros(t.shape)
    return out


def lm_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``CharTransformerLM`` params (numpy tree, the ``"params"``
    collection) -> state dict of ``lm/model.CharTransformerLM``."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(params):
        a = _to_f32(leaf)
        *mod, name = path
        if path == ("embed", "embedding"):
            key = "embed.weight"
        elif path == ("pos_embed",):
            key = "pos_embed"
        elif name == "kernel":
            if mod[-2:-1] == ["attn"] and mod[-1] != "out":
                a = a.reshape(a.shape[0], -1).T        # (d, H, Dh) -> (HDh, d)
            elif mod[-2:] == ["attn", "out"]:
                a = a.reshape(-1, a.shape[-1]).T       # (H, Dh, d) -> (d, HDh)
            elif a.ndim == 2:
                a = a.T                                # (I, O) -> (O, I)
            else:
                raise ValueError(f"unexpected kernel {'/'.join(path)}: "
                                 f"{a.shape}")
            key = ".".join([*mod, "weight"])
        elif name == "bias":
            key, a = ".".join([*mod, "bias"]), a.reshape(-1)
        elif name == "scale":
            key = ".".join([*mod, "weight"])
        else:
            raise ValueError(f"unexpected LM parameter {'/'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def seeded_lm_state_dict(config: Mapping,
                         seed: int) -> Dict[str, torch.Tensor]:
    """Random f32 weights for a ``CharTransformerLM`` of ``config`` from a
    ``torch.Generator`` seed, after flax's initialisers: embedding ~
    N(0, 1/d), dense and attention weights ~ N(0, 1/fan_in), positional
    embedding ~ N(0, 0.02^2), biases 0, LayerNorm at identity."""
    from ..lm.model import CharTransformerLM
    shapes = CharTransformerLM(**config).state_dict()
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    for key, t in shapes.items():
        name = key.rsplit(".", 1)[-1]
        if key == "pos_embed":
            out[key] = torch.randn(t.shape, generator=g) * 0.02
        elif name == "weight" and t.dim() == 2:
            # (out, in): fan_in is the row length, the embedding's d too
            out[key] = torch.randn(t.shape, generator=g) / math.sqrt(
                t.shape[1])
        elif name == "weight":
            out[key] = torch.ones(t.shape)
        else:
            out[key] = torch.zeros(t.shape)
    return out
