"""The port's ``compat/torch_convert.py`` against the JAX package's.

Reference-layout state dicts are built here from the port's models (the
reference's checkpoints are not in the repository): ``hctr-tiny`` with
demo/hard's trained weights, and ``innovation`` plain and with both
options, with seeded weights. On each, the port's converter equals the JAX
package's ``convert_state_dict`` followed by ``flax_to_torch``, exactly,
and gives the port's weights back; the JAX model on the JAX conversion
gives the port model's logits (so the layout built here, the head's
``(C, H)`` flatten included, is the one the JAX converter reads). The
``.pth.tar`` payload (``{epoch, state_dict, best_acc, optimizer}``, the DDP
``module.`` prefix, an SGD optimizer's state) loads in both.
"""

import os

import jax
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.compat import torch_convert as jconv
from handwritten_chinese_ocr_samples_tpu.models import registry as jreg
from handwritten_chinese_ocr_samples_torch.compat import torch_convert as conv
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    flax_to_torch, seeded_state_dict)
from tests.torch_reference_layout import reference_state_dict
from tests.test_torch_lm import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARD = os.path.join(REPO, "demo", "hard", "data")
TINY = os.path.join(REPO, "handwritten_chinese_ocr_samples_torch", "assets",
                    "demo_hard", "hctr_tiny.pt")
CHARS = os.path.join(HARD, "chars_list.txt")
MODELS = {"hctr-tiny": {}, "innovation": {},
          "innovation-ms-sa": dict(use_multiscale=True,
                                   use_spatial_attn=True)}
LOGIT_TOL = 1e-4       # of the largest logit, f32


def _port_state(name: str):
    tag = name.split("-ms")[0]
    model, _ = get_model_info(tag, chars_list_file=CHARS, **MODELS[name])
    if tag == "hctr-tiny":
        state = torch.load(TINY, map_location="cpu", weights_only=True)
    else:
        state = seeded_state_dict(model, 3)
        if "spatial_attn.gamma" in state:
            state["spatial_attn.gamma"] = torch.tensor([0.37])
        state = {k: v + 0.01 * torch.arange(v.numel()).reshape(v.shape)
                 % 0.3 if k.endswith(("running_mean", "bias")) else v
                 for k, v in state.items()}
    model.load_state_dict(state)
    return model.eval(), state


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_converter_equals_jax(name):
    model, state = _port_state(name)
    ref = reference_state_dict(state)
    assert any(k.endswith("num_batches_tracked") for k in ref)
    got = conv.convert_state_dict(ref)
    want = flax_to_torch(jconv.convert_state_dict(_numpy(ref)))
    assert got.keys() == want.keys() == state.keys()
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, state[k]), k

    # the JAX model reads the JAX conversion as the port reads its own
    tag = name.split("-ms")[0]
    side = 128 if tag == "innovation" else None
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 128, side or 96, 1)).astype(np.float32)
    jax.config.update("jax_platforms", "cpu")
    jmodel, _ = jreg.get_model_info(tag, chars_list_file=CHARS,
                                    **MODELS[name])
    jlogits = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False))(jconv.convert_state_dict(_numpy(ref)), x))
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    assert np.abs(logits - jlogits).max() <= LOGIT_TOL * np.abs(
        jlogits).max()


def test_pth_tar_payload_loads_as_jax(tmp_path):
    """A training checkpoint as the reference writes it: the state dict
    under ``module.`` (DDP), the epoch, best_acc and an SGD optimizer's
    state; read with ``weights_only=True``."""
    model, state = _port_state("hctr-tiny")
    ref = reference_state_dict(state)
    params = [torch.nn.Parameter(v.clone()) for v in list(ref.values())[:3]
              if v.is_floating_point()]
    opt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    sum(p.sum() for p in params).backward()
    opt.step()
    path = str(tmp_path / "hctr_checkpoint.pth.tar")
    torch.save({"epoch": 7, "best_acc": 0.91,
                "state_dict": {f"module.{k}": v for k, v in ref.items()},
                "optimizer": opt.state_dict()}, path)
    got = conv.convert_checkpoint(path)
    want = flax_to_torch(jconv.convert_state_dict(jconv.load_pth_tar(path)))
    assert got.keys() == want.keys() == state.keys()
    for k, v in got.items():
        assert torch.equal(v, want[k]) and torch.equal(v, state[k]), k
    # a bare state dict in a .pth
    torch.save(ref, str(tmp_path / "bare.pth"))
    bare = conv.convert_checkpoint(str(tmp_path / "bare.pth"))
    assert all(torch.equal(bare[k], state[k]) for k in state)


def test_converter_refuses_unknown_keys():
    with pytest.raises(ValueError, match="unhandled torch key"):
        conv.convert_state_dict({"cnn.prelu.weight": torch.ones(4)})
    with pytest.raises(ValueError, match="unhandled torch key"):
        conv.convert_state_dict({"cnn.attn.scale": torch.ones(4)})
