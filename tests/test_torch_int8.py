"""The port's int8 recognizer forward (``ops/int8_conv``, ``models/hctr.Conv``
with its int8 state, ``serve/quant``, ``ServingEngine(int8=True)``) against
the JAX package's ``QuantizableConv`` and ``serve/quant``, on the CPU, where
I1's wrappers run their plain versions.

* Quantize: equal to ``jnp.clip(jnp.round(x / s_x), -127, 127)`` element for
  element, exact .5 ties and amax 0 included.
* One site: the port's f32 output equals ``QuantizableConv.apply(...,
  amax)``'s bit for bit (the JAX call runs eagerly, so XLA contracts
  nothing), at (3, 3) and (1, 1) with Cin 1, 8 and 64.
* The plain integer product equals an int64 numpy sum.
* Calibration: the same 17 ``hctr-tiny`` sites under the converted names,
  each absmax within 1e-6 relative of JAX's.
* The whole trained ``hctr-tiny`` (demo/hard) in f32 on JAX's calibration,
  and the int8 engine's texts against the JAX int8 engine's.
* ``tools/convert_to_torch.py --int8``'s calibration tree (``int8.json``)
  equals a fresh JAX calibration on the JAX engine's first batch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.core.codec import (
    CTCCodec as JaxCodec)
from handwritten_chinese_ocr_samples_tpu.data.bucketing import (
    AlignCollate, BucketSpec)
from handwritten_chinese_ocr_samples_tpu.data.dataset import ImageDataset
from handwritten_chinese_ocr_samples_tpu.eval.driver import (
    load_recognizer_variables)
from handwritten_chinese_ocr_samples_tpu.models import registry as jreg
from handwritten_chinese_ocr_samples_tpu.models.hctr import QuantizableConv
from handwritten_chinese_ocr_samples_tpu.serve import quant as jquant
from handwritten_chinese_ocr_samples_tpu.serve.engine import (
    ServingEngine as JaxEngine)
from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
from handwritten_chinese_ocr_samples_torch.models.hctr import Conv
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.ops import int8_conv as ic
from handwritten_chinese_ocr_samples_torch.serve import quant
from handwritten_chinese_ocr_samples_torch.serve.engine import ServingEngine
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    flax_to_torch, quant_flax_to_torch)
from tools import convert_to_torch as conv

from tests.test_torch_lm import one_torch_thread  # noqa: F401

DATA = os.path.join(conv.DEMO, "data")
WEIGHTS = os.path.join(conv.OUT, "hctr_tiny.pt")
TINY_SITES = 17            # 2 + 4 x (1 block x 2 + 1) + 3 down_convs


def _jax_q(x, s_x):
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / s_x), -127, 127)
                      .astype(jnp.int8))


def _s_x(amax):
    return ic.scale_of(torch.tensor([amax], dtype=torch.float32))


@pytest.mark.parametrize("case", ["random", "ties", "amax0", "bf16", "rows"])
def test_quantize_matches_jax(case):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 7, 3)) * 40).astype(np.float32)
    amax = float(np.abs(x).max() * 0.8)         # some values clip
    if case == "ties":
        # amax 127: s_x = 1 and every x = k + 0.5 is a tie, even and odd k
        x = (rng.integers(-140, 140, size=(2, 5, 7, 3)) + 0.5).astype(
            np.float32)
        amax = 127.0
    elif case == "amax0":
        amax = 0.0                              # s_x = 1e-8 / 127
        x[0, 0, 0] = 0.0
    elif case == "bf16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    elif case == "rows":
        x = x.reshape(-1, 3)
    s_x = _s_x(amax)
    assert s_x.item() == np.float32(max(np.float32(amax), np.float32(1e-8))
                                    ) / np.float32(127)
    want = _jax_q(x, s_x.item())
    t = torch.from_numpy(x)
    if t.dim() == 4:
        t = t.permute(0, 3, 1, 2)               # the port quantizes NCHW
    if case == "bf16":
        t = t.bfloat16()
    got = ic.quantize(t, s_x)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "ties":
        assert np.any(want % 2 == 0) and np.all(np.abs(want) <= 127)
        np.testing.assert_array_equal(
            want[np.abs(x) < 127], np.round(x[np.abs(x) < 127]))


@pytest.mark.parametrize("kernel", [(3, 3), (1, 1)])
@pytest.mark.parametrize("cin", [1, 8, 64])
def test_one_site_equals_quantizable_conv(kernel, cin):
    rng = np.random.default_rng(cin)
    x = (rng.normal(size=(2, 9, 13, cin)) * 2).astype(np.float32)
    mod = QuantizableConv(16, kernel, padding=kernel[0] // 2,
                          dtype=jnp.float32)
    kern = mod.init({"params": jax.random.key(1)},
                    jnp.asarray(x))["params"]["kernel"]
    bias = rng.normal(size=16).astype(np.float32)
    amax = np.float32(np.abs(x).max() * 0.9)
    want = np.asarray(mod.apply(
        {"params": {"kernel": kern, "bias": jnp.asarray(bias)}},
        jnp.asarray(x), jnp.asarray(amax)))
    site = Conv(cin, 16, kernel, padding=kernel[0] // 2)
    with torch.no_grad():
        site.weight.copy_(torch.from_numpy(
            np.asarray(kern).transpose(3, 2, 0, 1).copy()))
        site.bias.copy_(torch.from_numpy(bias))
    site.set_amax(float(amax))
    with torch.no_grad():
        got = site(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("kernel,cin,hw", [((3, 3), 1, (5, 6)),
                                           ((3, 3), 24, (4, 9)),
                                           ((1, 1), 40, (3, 3)),
                                           ((1, 1), 2048, None)])
def test_plain_int8_product_is_exact(kernel, cin, hw):
    """The plain version's s32 sums equal int64 sums, at the extremes of
    the s8 range too, with K padded to 32 (Cin 1: K 9; 24 x 9 = 216) and
    as a GEMM (``(M, K)`` rows, out ``(M, N)``)."""
    rng = np.random.default_rng(cin)
    kh, kw = kernel
    N = 10
    shape = (3, cin) if hw is None else (2, *hw, cin)
    xq = rng.integers(-127, 128, size=shape).astype(np.int8)
    xq.flat[:cin] = -127
    wq = rng.integers(-127, 128, size=(N, kh, kw, cin)).astype(np.int8)
    wq[0] = -127
    packed = ic.pack_weight(torch.from_numpy(wq.reshape(N, -1)))
    assert packed.shape[1] % 32 == 0 and not packed[:, kh * kw * cin:].any()
    one = torch.ones(1)
    scale = torch.ones(N)
    got = ic.conv_int8(torch.from_numpy(xq), packed, one, scale, None, kh,
                       kw, torch.float32)
    x64 = xq.astype(np.int64)
    if hw is None:
        want = x64 @ wq.reshape(N, -1).astype(np.int64).T
    else:
        p = kh // 2
        xp = np.pad(x64, ((0, 0), (p, p), (p, p), (0, 0)))
        H, W = hw
        want = np.zeros((2, N, H, W), np.int64)
        for dy in range(kh):
            for dx in range(kw):
                want += np.einsum("bhwc,nc->bnhw",
                                  xp[:, dy:dy + H, dx:dx + W],
                                  wq[:, dy, dx].astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    # the dequantisation: ((f32) acc * alpha) * scale + bias, each rounded
    alpha = torch.tensor([0.37], dtype=torch.float32)
    sc = torch.from_numpy(rng.uniform(0.001, 0.01, N).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    y = ic.conv_int8(torch.from_numpy(xq), packed, alpha, sc, b, kh, kw,
                     torch.bfloat16)
    bshape = (N,) if hw is None else (N, 1, 1)
    ref = ((torch.from_numpy(want.astype(np.float32)) * alpha)
           * sc.reshape(bshape) + b.reshape(bshape)).bfloat16()
    assert torch.equal(y, ref)


def test_site_subset_and_state():
    """The int8 state goes on and off a site, the float path unchanged
    byte for byte; a site outside the supported subset raises, as
    ``QuantizableConv`` does."""
    torch.manual_seed(0)
    site = Conv(4, 6, 3, padding=1)
    x = torch.randn(1, 4, 5, 5)
    with torch.no_grad():
        want = site(x)
        site.set_amax(float(x.abs().max()))
        assert site.int8 is not None and site.int8.w_q.shape == (6, 64)
        q = site(x)
        site.set_amax(None)
        assert torch.equal(site(x), want) and not torch.equal(q, want)
    assert (q - want).abs().max() < 0.05 * want.abs().max()
    for bad in (Conv(4, 6, 3, padding=1, stride=2),
                Conv(4, 6, 3, padding=1, dilation=2),
                Conv(4, 4, 3, padding=1, groups=2),
                Conv(4, 6, 3, padding=0), Conv(4, 6, 5, padding=2)):
        with pytest.raises(NotImplementedError, match="stride-1"):
            bad.set_amax(1.0)


def test_quant_tree_conversion():
    tree = {"cnn": {"conv0_1": np.float32(0.5),
                    "block1_0": {"conv1": np.float32(2.25),
                                 "down_conv": np.float32(1e-9)}}}
    assert quant_flax_to_torch(tree) == {
        "cnn.conv0_1": 0.5, "cnn.block1_0.conv1": 2.25,
        "cnn.block1_0.down_conv": float(np.float32(1e-9))}


# ------------------------------------------------------- the trained model
@pytest.fixture(scope="module")
def trained():
    """demo/hard's hctr-tiny in f32 in both packages, and the first four
    test lines at width 256."""
    jax.config.update("jax_platforms", "cpu")
    jm, _ = jreg.get_model_info("hctr-tiny", data_dir=DATA,
                                dtype=jnp.float32)
    jv = load_recognizer_variables(os.path.join(conv.DEMO, "checkpoint"))
    ds = ImageDataset(DATA, (1, 128), "test", batch_size=4)
    col = AlignCollate(imgH=128, PAD="NormalizePAD", bucket_spec=BucketSpec())
    x = col([ds[i] for i in range(4)])["images"][:, :, :256]
    model, _ = get_model_info("hctr-tiny", data_dir=DATA)
    model.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, jv)))
    return jm, jv, x, model.eval()


def test_calibration_matches_jax(trained):
    jm, jv, x, model = trained
    want = quant_flax_to_torch(jquant.calibrate_conv_amax(
        jm, jv, [jnp.asarray(x)]))
    got = quant.calibrate_for_model(model, [torch.from_numpy(x)])
    assert all(m.int8 is not None for m in quant.conv_sites(model).values())
    assert sorted(got) == sorted(want) == sorted(quant.conv_sites(model))
    assert quant.conv_site_count(got) == TINY_SITES
    assert "cnn.block1_0.down_conv" in got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * want[k], k
    # two batches: the maximum of the two, from float forwards
    two = quant.calibrate_conv_amax(model, [torch.from_numpy(x[:2]),
                                            torch.from_numpy(x[2:])])
    assert two == got
    quant.set_conv_amax(model, None)
    assert all(m.int8 is None for m in quant.conv_sites(model).values())


def test_whole_model_int8_matches_jax(trained):
    """hctr-tiny in f32 on JAX's calibration tree (B 4, W 256): the port's
    int8 logits lie within a tenth of JAX int8's distance from JAX float,
    and the frame argmax agrees on 99.9% of frames or more. Measured on
    the CPU: port vs JAX int8 7.6e-5 (the f32 forwards' own distance), JAX
    int8 vs float 2.59, argmax equal on all 1024 frames."""
    jm, jv, x, model = trained
    tree = jquant.calibrate_conv_amax(jm, jv, [jnp.asarray(x)])
    jf = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
    jq = np.asarray(jm.apply(jv, jnp.asarray(x), train=False, quant=tree))
    quant.set_conv_amax(model, quant_flax_to_torch(tree))
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
    finally:
        quant.set_conv_amax(model, None)
    noise = np.abs(jq - jf).max()
    assert noise > 0.1
    assert np.abs(got - jq).max() <= 0.1 * noise
    assert (got.argmax(-1) == jq.argmax(-1)).mean() >= 0.999
    with pytest.raises(KeyError, match="conv sites"):
        quant.set_conv_amax(model, {"cnn.conv0_1": 1.0})


def test_int8_reference_tree_equals_fresh_calibration(trained):
    with open(os.path.join(conv.OUT, "int8.json"), encoding="utf-8") as f:
        ref = json.load(f)
    jm, jv, _, _ = trained
    batch = conv.first_batch(conv.DEMO)
    x = (jnp.asarray(batch).astype(jnp.float32) - 127.5) / 127.5
    tree = jax.tree.map(lambda a: float(np.float32(a)),
                        jquant.calibrate_conv_amax(jm, jv, [x]))
    assert tree == ref["calibration"]
    assert len(quant_flax_to_torch(tree)) == TINY_SITES
    assert ref["files"] == sorted(os.listdir(os.path.join(DATA, "test")))
    for route in ("greedy", "ss"):
        assert len(ref[route]) == 150 and all(ref[route])


def test_engine_int8_matches_jax_engine():
    """``ServingEngine(int8=True)`` calibrates on its first batch, and in
    f32 on 8 demo/hard lines serves the JAX int8 engine's texts; at most 2
    of the 8 differ from the float engine (the JAX test's own rule)."""
    test_dir = os.path.join(DATA, "test")
    files = [os.path.join(test_dir, f)
             for f in sorted(os.listdir(test_dir))][:8]
    jax.config.update("jax_platforms", "cpu")
    jm, chars = jreg.get_model_info("hctr-tiny", data_dir=DATA,
                                    dtype=jnp.float32)
    jv = load_recognizer_variables(os.path.join(conv.DEMO, "checkpoint"))
    jeng = JaxEngine(jm, jv, JaxCodec(chars), widths=(512,),
                     batch_sizes=(4,), int8=True)
    want, _ = jeng.infer_files_batched(files, batch_size=4)
    state = torch.load(WEIGHTS, weights_only=True)
    model, chars = get_model_info("hctr-tiny", data_dir=DATA)
    engine = ServingEngine(model, state, CTCCodec(chars), widths=(512,),
                           int8=True, device="cpu")
    assert engine._quant is None
    got, _ = engine.infer_files_batched(files, batch_size=4)
    assert sorted(engine._quant) == sorted(quant.conv_sites(model))
    assert model.cnn.conv0_1.int8 is not None
    assert got == want and all(got)
    # the JAX engine calibrated on the same batch
    jtree = quant_flax_to_torch(jeng._quant)
    assert all(abs(engine._quant[k] - jtree[k]) <= 1e-6 * jtree[k]
               for k in jtree)
    fmodel, _ = get_model_info("hctr-tiny", data_dir=DATA)
    floats, _ = ServingEngine(fmodel, state, CTCCodec(chars), widths=(512,),
                              device="cpu").infer_files_batched(
                                  files, batch_size=4)
    assert sum(a != b for a, b in zip(got, floats)) <= 2
