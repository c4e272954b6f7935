"""The port's weight bridge and model against the flax reference.

Same numpy inputs through the flax ``HCTRModel`` and the port's torch
``HCTRModel`` on converted weights. Tolerance: f32 logits agree to
rtol/atol 1e-4 (the two frameworks sum the convolutions in another order);
the per-frame argmax must be identical.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.models.hctr import (
    HCTRModel as FlaxHCTR, hctr_model as flax_hctr_model)
from handwritten_chinese_ocr_samples_tpu.utils.ckpt_io import (
    restore_pytree_host)
from handwritten_chinese_ocr_samples_torch.models.hctr import (
    HCTRModel, hctr_model)
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    flax_to_torch, seeded_state_dict)

from tests.test_torch_lm import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_CKPT = os.path.join(REPO, "demo", "checkpoint")
DEMO_CHARS = os.path.join(REPO, "demo", "data", "chars_list.txt")
TOL = 1e-4


def _tiny_pair(num_classes, seed):
    flax_model = FlaxHCTR(num_classes=num_classes, backbone_channels=64,
                          num_blocks=(1, 1, 1, 1))
    variables = flax_model.init({"params": jax.random.key(seed)},
                                jnp.zeros((1, 128, 16, 1)), train=False)
    host = jax.tree.map(np.asarray, variables)
    # non-trivial BatchNorm statistics, so the stats mapping is exercised
    rng = np.random.default_rng(seed)
    host["batch_stats"] = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a
                   ).astype(np.float32), host["batch_stats"])
    return flax_model, host


def _compare(flax_model, variables, torch_model, x):
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x),
                                       train=False))
    torch_model.load_state_dict(flax_to_torch(variables))
    with torch.no_grad():
        got = torch_model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("seed,width", [(0, 40), (1, 64)])
def test_tiny_init_matches_flax(seed, width):
    flax_model, variables = _tiny_pair(12, seed)
    model = HCTRModel(num_classes=12, backbone_channels=64,
                      num_blocks=(1, 1, 1, 1))
    x = np.random.default_rng(seed).uniform(
        -1, 1, (2, 128, width, 1)).astype(np.float32)
    _compare(flax_model, variables, model, x)


def test_demo_checkpoint_matches_flax():
    payload = restore_pytree_host(DEMO_CKPT)
    variables = {"params": payload["params"],
                 "batch_stats": payload["batch_stats"]}
    model, chars = get_model_info("hctr-tiny", chars_list_file=DEMO_CHARS)
    flax_model = FlaxHCTR(num_classes=len(chars) + 2, backbone_channels=64,
                          num_blocks=(1, 1, 1, 1))
    import cv2
    img = cv2.imread(os.path.join(REPO, "demo", "data", "test",
                                  "test_0001.png"), cv2.IMREAD_GRAYSCALE)
    x = ((img.astype(np.float32) - 127.5) / 127.5)[None, :, :, None]
    _compare(flax_model, variables, model, x)


def test_full_hctr_keys_and_shapes():
    """The full-width flax tree converts to exactly the port's state dict
    (names and shapes), with no forward run."""
    flax_model = flax_hctr_model(7375)
    shapes = jax.eval_shape(
        lambda: flax_model.init({"params": jax.random.key(0)},
                                jnp.zeros((1, 128, 8, 1)), train=False))
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), ml_dtypes.bfloat16), s.shape),
        shapes)
    converted = flax_to_torch(zeros)
    with torch.device("meta"):
        model = hctr_model(7375)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in converted.items()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in converted.values())
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(s.shape))
                           for s in jax.tree.leaves(shapes["params"]))


def test_bf16_leaves_upcast_to_f32():
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(3, 3, 2, 4)).astype(ml_dtypes.bfloat16)
    tree = {"params": {"conv": {"kernel": kernel,
                                "bias": np.zeros(4, ml_dtypes.bfloat16)},
                       "bn": {"scale": np.ones(4, np.float16),
                              "bias": np.zeros(4, np.float64)}},
            "batch_stats": {"bn": {"mean": np.zeros(4, ml_dtypes.bfloat16),
                                   "var": np.ones(4, ml_dtypes.bfloat16)}}}
    sd = flax_to_torch(tree)
    assert set(sd) == {"conv.weight", "conv.bias", "bn.weight", "bn.bias",
                       "bn.running_mean", "bn.running_var"}
    assert all(v.dtype == torch.float32 for v in sd.values())
    np.testing.assert_array_equal(
        sd["conv.weight"].numpy(),
        kernel.astype(np.float32).transpose(3, 2, 0, 1))


def test_seeded_weights_are_reproducible():
    model, _ = get_model_info("hctr-tiny", chars_list_file=DEMO_CHARS)
    a, b = seeded_state_dict(model, 3), seeded_state_dict(model, 3)
    assert a.keys() == model.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["linear.weight"],
                           seeded_state_dict(model, 4)["linear.weight"])
