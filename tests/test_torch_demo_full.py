"""The trained full-size ``demo/full`` artifact in the port's format
(``handwritten_chinese_ocr_samples_torch/assets/demo_full/``, written by
``tools/convert_to_torch.py --full``) against the orbax trees it came from,
and the packed format's reader (``utils.weights.load_packed``) and its
users, ``cli/deploy.load_weights`` and ``lm/io.load_lm``.

The packed state dicts hold every tensor in the dtype the checkpoint stores
(bf16 parameters, f32 batch statistics) and must equal the orbax trees bit
for bit; the loaders normalise them to f32 as they do a ``.pt``. No test
here runs the 38M forward or the JAX eval on ``demo/full``:
``chip_smoke.py``'s ``demo_full`` phase does that on the card.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_tpu.utils.ckpt_io import (
    restore_pytree_host)
from handwritten_chinese_ocr_samples_torch.cli import deploy
from handwritten_chinese_ocr_samples_torch.eval.metrics import cer_counts
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.utils.weights import (
    PART_BYTES, flax_to_torch, lm_flax_to_torch, load_packed, save_packed,
    seeded_state_dict)

from tests.test_torch_lm import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = os.path.join(REPO, "demo", "full")
ASSETS = os.path.join(REPO, "handwritten_chinese_ocr_samples_torch",
                      "assets", "demo_full")
CHARS = os.path.join(REPO, "demo", "data", "chars_list.txt")


def test_packed_artifact_bit_equal_to_orbax():
    """Both packed files hold each tensor of the converted orbax trees in
    the dtype its collection is stored in (155 bf16 parameters and 66 f32
    batch statistics of the recognizer, 100 bf16 tensors of the LM), and
    widen to the f32 conversion of the orbax leaves exactly: bit for bit,
    since every stored value is exact in f32."""
    def host(tree):
        return {k: host(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in tree.items()}

    payload = restore_pytree_host(os.path.join(FULL, "checkpoint"))
    lm = restore_pytree_host(os.path.join(FULL, "lm", "weights"))["params"]
    cases = (
        ("hctr.pt.xz", {
            **{k: torch.bfloat16 for k in flax_to_torch(
                {"params": host(payload["params"])})},
            **{k: torch.float32 for k in flax_to_torch(
                {"batch_stats": host(payload["batch_stats"])})}},
         flax_to_torch(host({"params": payload["params"],
                             "batch_stats": payload["batch_stats"]})),
         {torch.bfloat16: 155, torch.float32: 66}),
        (os.path.join("lm", "weights.pt.xz"),
         {k: torch.bfloat16 for k in lm_flax_to_torch(host(lm))},
         lm_flax_to_torch(host(lm)), {torch.bfloat16: 100}))
    for name, dtypes, want, counts in cases:
        got = load_packed(os.path.join(ASSETS, name))
        assert sorted(got) == sorted(want), name
        for key, w in want.items():
            g = got[key]
            assert g.dtype == dtypes[key] and g.shape == w.shape, key
            assert torch.equal(g.float(), w), key
        n = {}
        for t in got.values():
            n[t.dtype] = n.get(t.dtype, 0) + 1
        assert n == counts, name


def test_artifact_files_and_manifests():
    """No file of the artifact is larger than a part; each manifest names
    parts that exist with its lengths and sha256; ``texts.json`` holds the
    JAX eval's greedy and ``-ss`` texts for all 150 lines, each route's CER equal to the one the
    port's metric gives its texts, and the JAX engine's greedy and ``-ss``
    texts for all 150 lines at batch 8 on its three width buckets."""
    sizes = [os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(ASSETS) for f in files]
    assert sizes and max(sizes) <= PART_BYTES
    for name in ("hctr.pt.xz", os.path.join("lm", "weights.pt.xz")):
        path = os.path.join(ASSETS, name)
        with open(path + ".json") as f:
            manifest = json.load(f)
        for part in manifest["parts"]:
            with open(os.path.join(os.path.dirname(path), part["name"]),
                      "rb") as f:
                data = f.read()
            assert len(data) == part["bytes"] <= PART_BYTES
            assert hashlib.sha256(data).hexdigest() == part["sha256"]
    with open(os.path.join(ASSETS, "texts.json"), encoding="utf-8") as f:
        ref = json.load(f)
    with open(os.path.join(FULL, "data", "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        labels = dict(row.rstrip("\n").split(",", 1) for row in f if row)
    assert len(ref["files"]) == 150 and ref["batch"] == 25
    for route in ("greedy", "lm_ss"):
        texts = ref[route]["texts"]
        assert len(texts) == ref[route]["lines"] == 150
        dist, total = cer_counts(texts, [labels[n] for n in ref["files"]])
        assert dist / total == pytest.approx(ref[route]["cer"], abs=1e-12)
        assert ref[route]["command"].startswith(
            "-m hctr -f demo/full/checkpoint -i demo/full/data")
    for route in ("engine_greedy", "engine_ss"):
        assert ref[route]["lines"] == len(ref[route]["texts"]) == 150
        assert (ref[route]["batch"], ref[route]["widths"]) == (
            8, [512, 1024, 1600])


def test_packed_manifest_check(tmp_path):
    """A packed file reads back equal; a part cut short, one of the right
    length whose bytes changed, a missing part and a missing manifest each
    raise, naming what failed."""
    state = {"w": torch.arange(4096, dtype=torch.float32).view(64, 64),
             "b": torch.ones(3, dtype=torch.bfloat16)}
    path = str(tmp_path / "x.pt.xz")
    manifest = save_packed(state, path, part_bytes=512)
    assert len(manifest["parts"]) > 2
    got = load_packed(path)
    assert all(torch.equal(got[k], v) and got[k].dtype == v.dtype
               for k, v in state.items())
    part = tmp_path / "x.pt.xz.1"
    data = part.read_bytes()
    part.write_bytes(data[:-1])
    with pytest.raises(ValueError, match=r"x\.pt\.xz\.1 .* holds 511 bytes"):
        load_packed(path)
    part.write_bytes(data[:7] + bytes([data[7] ^ 1]) + data[8:])
    with pytest.raises(ValueError, match=r"x\.pt\.xz\.1 .* sha256"):
        load_packed(path)
    part.unlink()
    with pytest.raises(FileNotFoundError, match=r"x\.pt\.xz\.1 .* missing"):
        load_packed(path)
    save_packed(state, path, part_bytes=1 << 20)      # one part: stale ones go
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "x.pt.xz.0", "x.pt.xz.json"]
    (tmp_path / "x.pt.xz.json").unlink()
    with pytest.raises(FileNotFoundError, match="manifest"):
        load_packed(path)


def test_load_weights_reads_packed_like_pt(tmp_path):
    """``cli/deploy.load_weights`` reads a packed state dict as it reads the
    same dict saved as a ``.pt``: f32 from bf16 storage, equal tensors."""
    model, _ = get_model_info("hctr-tiny", chars_list_file=CHARS)
    state = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in seeded_state_dict(model, 0).items()}
    torch.save(state, str(tmp_path / "w.pt"))
    save_packed(state, str(tmp_path / "w.pt.xz"), part_bytes=1 << 18)
    want = deploy.load_weights(str(tmp_path / "w.pt"), model)
    got = deploy.load_weights(str(tmp_path / "w.pt.xz"), model)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k].float()), k
    model.load_state_dict(got)
