"""The port's ``models/innovation.py`` against the JAX package's.

Full channel widths (the JAX model fixes them: 64/128/256/512/512, blocks
[2, 4, 5, 1]) at a 64x64 input, b2, f32, the same weights (the JAX
``init``'s, with a nonzero ``gamma``, through ``flax_to_torch``), in eval
mode and in train mode (train-mode BatchNorm; dropout off on both sides:
rates 0 on the port, flax's ``Dropout`` and the JAX package's block dropout
patched to the identity inside the test), for the plain classifier and for
the multiscale + spatial-attention one. Logits within 1e-4 of the largest;
the new BatchNorm running statistics within 1e-5.

The fusion resizes 8x8, 4x4 and 2x2 stage outputs to 1x1 here: a shrinking
``jax.image.resize`` antialiases, so the port resizes with
``antialias=True`` (``test_fusion_resize_matches_jax`` holds that alone at
the 128x128 input's 32/16/8 -> 4).
"""

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from handwritten_chinese_ocr_samples_tpu.models import hctr as jhctr
from handwritten_chinese_ocr_samples_tpu.models import innovation as jinn
from handwritten_chinese_ocr_samples_torch.models import innovation as tinn
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    flax_to_torch, init_state_dict)

from tests.test_torch_lm import one_torch_thread  # noqa: F401

CLASSES, B, H = 37, 2, 64
LOGIT_TOL, STAT_TOL = 1e-4, 1e-5
NO_DROP = dict(stage_drop=(0.0,) * 4, block_drop=0.0, head_drop=0.0)
VARIANTS = {"plain": (False, False), "multiscale_attn": (True, True)}


class _NoDropout(fnn.Module):
    """The identity, with the signatures of flax's ``Dropout`` and the JAX
    package's ``_Dropout``."""

    rate: float = 0.0
    deterministic: Optional[bool] = None

    def __call__(self, x, deterministic=None):
        return x


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(jhctr, "_Dropout", _NoDropout)


def _images(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (B, H, H, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX init of each variant at 64x64, ``gamma`` set to 0.37."""
    out = {}
    for name, (ms, sa) in VARIANTS.items():
        model = jinn.innovation_model(CLASSES, use_multiscale=ms,
                                      use_spatial_attn=sa)
        v = jax.jit(model.init, static_argnames=("train",))(
            jax.random.key(3), jnp.zeros((1, H, H, 1)), train=False)
        v = jax.tree.map(np.asarray, v)
        if sa:
            v["params"]["spatial_attn"]["gamma"] = np.array([0.37],
                                                             np.float32)
        # non-trivial running statistics for the eval forward
        rng = np.random.default_rng(1)
        v["batch_stats"] = jax.tree.map(
            lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a
                       ).astype(np.float32), v["batch_stats"])
        out[name] = (model, v)
    return out


def _port(name: str, variables: dict) -> tinn.InnovationModel:
    ms, sa = VARIANTS[name]
    model = tinn.innovation_model(CLASSES, use_multiscale=ms,
                                  use_spatial_attn=sa, **NO_DROP)
    model.load_state_dict(flax_to_torch(variables))
    return model


def _check_logits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("name", list(VARIANTS))
def test_eval_forward_matches_jax(jax_variables, name):
    model, v = jax_variables[name]
    x = _images()
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(v, x)
    port = _port(name, v).eval()
    with torch.no_grad():
        _check_logits(port(torch.from_numpy(x)), want)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_train_forward_matches_jax(jax_variables, name, no_jax_dropout):
    model, v = jax_variables[name]
    x = _images(1)
    want, updates = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    port = _port(name, v).train()
    _check_logits(port(torch.from_numpy(x)), want)
    stats = flax_to_torch(jax.tree.map(np.asarray, updates))
    bns = dict(port.named_modules())
    checked = 0
    for key, w in stats.items():
        mod, leaf = key.rsplit(".", 1)
        mean, var = bns[mod].new_running_stats()
        got = mean if leaf == "running_mean" else var
        torch.testing.assert_close(got, w, rtol=0, atol=STAT_TOL)
        checked += 1
    assert checked == 2 * len(port.batch_norms())


def test_fusion_resize_matches_jax():
    """At a 128x128 input the stage outputs are 32, 16 and 8 square,
    resized to 4: ``antialias=True`` matches ``jax.image.resize``'s
    bilinear; without it the resize is another function."""
    rng = np.random.default_rng(2)
    for side in (32, 16, 8):
        y = rng.normal(0, 1, (2, side, side, 5)).astype(np.float32)
        want = np.asarray(jax.image.resize(y, (2, 4, 4, 5), "bilinear"))
        t = torch.from_numpy(y).permute(0, 3, 1, 2)
        got = torch.nn.functional.interpolate(
            t, size=(4, 4), mode="bilinear", align_corners=False,
            antialias=True).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        plain = torch.nn.functional.interpolate(
            t, size=(4, 4), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(plain - want).max() > 0.1


def test_registry_and_init():
    """``-m innovation`` through the registry: the JAX attributes, the
    parameter count of the JAX init at full width, flax's initialisers
    (``gamma`` 0, biases 0, BatchNorm at identity)."""
    import os
    chars = os.path.join(os.path.dirname(__file__), "..", "demo", "hard",
                         "data", "chars_list.txt")
    model, characters = get_model_info("innovation", chars_list_file=chars)
    assert isinstance(model, tinn.InnovationModel)
    assert (model.img_height, model.pad_mode, model.optimizer,
            model.pred) == (128, "NormalizePAD", "Adam", "Classification")
    assert model.fc.out_features == len(characters) + 2
    jmodel = jinn.innovation_model(len(characters) + 2)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 128, 128, 1)), train=False))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    state = init_state_dict(
        tinn.innovation_model(10, use_spatial_attn=True),
        torch.Generator().manual_seed(0))
    assert float(state["spatial_attn.gamma"]) == 0.0
    assert float(state["fc.bias"].abs().max()) == 0.0
    assert float(state["cnn.bn0_1.running_var"].min()) == 1.0
