"""The reference's ``.pth``/``.pth.tar`` checkpoints -> the port's state
dict (the JAX package's ``compat/torch_convert.py``).

The reference saves ``{epoch, state_dict, best_acc, optimizer}``
(`main.py:349-356`). Its layout is already torch's (convs OIHW, dense
``(O, I)``, BatchNorm ``weight/bias/running_mean/running_var``), so of the
JAX converter's translations these remain:

  * the DDP prefix ``module.`` is stripped (`main.py:260`) and
    ``num_batches_tracked`` dropped;
  * module names: ``blockN.i`` -> ``blockN_i``; ``downsample.0/.1`` ->
    ``down_conv``/``down_bn``; SE ``se.fc.0/.2`` -> ``se.fc1``/``se.fc2``;
    the classifier's fusion ``transforms.i.0/.1`` ->
    ``transform{i}_conv``/``transform{i}_bn`` and ``fusion.0/.1`` ->
    ``fusion_conv``/``fusion_bn`` (`innovation.py:199-212`);
  * the CTC head's input axis: the reference flattens ``(C, H)``, index
    ``c * H + h`` (`handwritten_ctr_model.py:173`), the port ``(H, C)``,
    index ``h * C + c`` (``models/hctr.py``), so ``linear.weight``'s
    columns are permuted;
  * floating tensors become f32 (the serving dtype contract).

"""

from __future__ import annotations

import re
from typing import Dict, List

import torch

# the feature height the CTC head flattens: 128 px pooled 32-fold
# (``models/hctr.py``, ``HCTRModel.img_height // 32``); both CTC models
# of the port have it
HEAD_HEIGHT = 4


def load_pth_tar(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's ``state_dict`` (or a bare state dict), the
    ``module.`` prefix stripped.

    Read with ``weights_only=True``: the file comes from outside this
    program, and a full unpickle can run code. The weights-only loader takes
    what the reference saves: tensors, numbers, and ``torch.optim``'s
    state (dicts, lists and tensors); a file holding other objects is
    refused with torch's message."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _module_path(torch_prefix: str) -> List[str]:
    """A reference module prefix -> the port's module path."""
    parts = torch_prefix.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        m = re.fullmatch(r"block(\d)", p)
        if m and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"block{m.group(1)}_{parts[i + 1]}")
            i += 2
        elif p == "downsample":
            out.append("down_conv" if parts[i + 1] == "0" else "down_bn")
            i += 2
        elif p == "transforms" and i + 2 < len(parts):
            out.append(f"transform{parts[i + 1]}_"
                       + ("conv" if parts[i + 2] == "0" else "bn"))
            i += 3
        elif (p == "fusion" and i + 1 < len(parts)
              and parts[i + 1].isdigit()):
            out.append("fusion_conv" if parts[i + 1] == "0"
                       else "fusion_bn")
            i += 2
        elif p == "se" and i + 2 < len(parts) and parts[i + 1] == "fc":
            out += ["se", "fc1" if parts[i + 2] == "0" else "fc2"]
            i += 3
        else:
            out.append(p)
            i += 1
    return out


def convert_state_dict(sd: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A reference state dict -> the port's."""
    out = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        *mod, leaf = key.split(".")
        path = _module_path(".".join(mod))
        v = val.detach().cpu()
        if v.is_floating_point():
            v = v.float()
        is_bn = f"{'.'.join(mod)}.running_mean" in sd
        if leaf == "weight" and v.ndim == 1 and not is_bn:
            raise ValueError(f"unhandled torch key: {key} {tuple(v.shape)}")
        if leaf == "weight" and v.ndim == 2 and path[-1:] == ["linear"]:
            o, ch = v.shape
            v = (v.reshape(o, ch // HEAD_HEIGHT, HEAD_HEIGHT)
                 .transpose(1, 2).reshape(o, ch))
        elif leaf not in ("weight", "bias", "running_mean", "running_var",
                          "gamma"):
            raise ValueError(f"unhandled torch key: {key}")
        out[".".join(path + [leaf])] = v.contiguous()
    return out


def convert_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """``.pth``/``.pth.tar`` file -> the port's state dict."""
    return convert_state_dict(load_pth_tar(path))
