"""The port's GNT prep (``data/prep/gnt.py``, ``flow.py``) against the JAX
package's, on files the test writes.

``gnt2png`` gives the same file names and the same pixels, and
``generate_char_img_gt`` the same manifest and code list, as the JAX
functions on one GNT zip (two ``.gnt`` members, glyphs wider and taller
than square, odd and even sides); the rest of ``flow`` (code maps, text
manifests, code-list merge, the alphanumeric filter, the split and the
vocabulary) gives the JAX outputs too.
"""

import filecmp
import os
import struct
import zipfile

import cv2
import numpy as np
import pytest

from handwritten_chinese_ocr_samples_tpu.data.prep import flow as jflow
from handwritten_chinese_ocr_samples_tpu.data.prep import gnt as jgnt
from handwritten_chinese_ocr_samples_torch.data import prep
from handwritten_chinese_ocr_samples_torch.data.prep import flow, gnt

TAGS = (0xB0A1, 0xB0A2, 0xD2BB, 0xA3B1, 0xB0A1)


def _write_gnt_zip(path: str, seed: int = 0) -> list:
    """Two .gnt members of seeded glyphs (tag, (H, W) uint8); returns the
    samples in file order."""
    rng = np.random.default_rng(seed)
    samples = []
    with zipfile.ZipFile(path, "w") as zf:
        for member in ("001-f.gnt", "002-f.gnt"):
            payload = b""
            for tag in TAGS:
                h, w = (int(v) for v in rng.integers(17, 60, 2))
                img = rng.integers(0, 256, (h, w), dtype=np.uint8)
                payload += struct.pack("<I", 10 + h * w)
                payload += struct.pack(">H", tag)
                payload += struct.pack("<HH", w, h)
                payload += img.tobytes()
                samples.append((tag, img))
            zf.writestr(member, payload)
    return samples


@pytest.mark.parametrize("size", [64, 128])
def test_gnt2png_and_manifest_match_jax(tmp_path, size):
    zp = str(tmp_path / "hwdb.zip")
    samples = _write_gnt_zip(zp)
    dirs = {}
    for name, mod in (("port", gnt), ("jax", jgnt)):
        out = tmp_path / name
        out.mkdir()
        # a tag twice in a member overwrites its file, in both
        assert mod.gnt2png(zp, size, str(out)) == len(samples)
        dirs[name] = out
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    assert len(names) == 8 and names[0] == f"001-f.gnt_{0xA3B1}.png"
    for n in names:
        a = cv2.imread(str(dirs["port"] / n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(dirs["jax"] / n), cv2.IMREAD_UNCHANGED)
        assert a.shape == (size, size) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        assert filecmp.cmp(dirs["port"] / n, dirs["jax"] / n, shallow=False)
    # the manifest reads the port's folder; the JAX one the same folder
    got_m, want_m = tmp_path / "port_gt.txt", tmp_path / "jax_gt.txt"
    codes = flow.generate_char_img_gt(str(dirs["port"]), str(got_m))
    assert codes == jflow.generate_char_img_gt(str(dirs["port"]),
                                               str(want_m))
    assert got_m.read_text(encoding="utf-8") == want_m.read_text(
        encoding="utf-8")
    assert codes == ["A3B1", "B0A1", "B0A2", "D2BB"]
    assert flow.map_codes_to_chars(codes) == ["１", "啊", "阿", "一"]


def test_iter_gnt_samples_centres_on_white(tmp_path):
    zp = str(tmp_path / "one.zip")
    samples = _write_gnt_zip(zp, seed=3)
    with zipfile.ZipFile(zp) as zf, zf.open("001-f.gnt") as fp:
        total = zf.getinfo("001-f.gnt").file_size
        got = list(gnt.iter_gnt_samples(fp, total))
    with zipfile.ZipFile(zp) as zf, zf.open("001-f.gnt") as fp:
        want = list(jgnt.iter_gnt_samples(fp, total))
    assert [s.tag_code for s in got] == list(TAGS)
    for g, w, (_, img) in zip(got, want, samples):
        np.testing.assert_array_equal(g.image, w.image)
        side = max(img.shape)
        assert g.image.shape == (side, side)
        assert (g.image == 255).sum() >= side * side - img.size


def test_flow_matches_jax(tmp_path):
    for code in ["B0A1", "D2BB", "A3FD", "4E00", "3000"]:
        assert flow.map_code_to_char(code) == jflow.map_code_to_char(code)
    codes = ["B0A1", "A1A1", "A9F0", "4E00", "D2BB", "3000"]
    assert (flow.select_alpha_symbol_codes(codes)
            == jflow.select_alpha_symbol_codes(codes))
    lists = (["B0A1", "A1A1"], ["A1A1", "D2BB"], ["D2BB", "4E00"])
    assert flow.generate_codes_list(*lists) == jflow.generate_codes_list(
        *lists)

    d = tmp_path / "lines"
    d.mkdir()
    cv2.imwrite(str(d / "a-L1.png"), np.zeros((10, 10), np.uint8))
    (d / "a-L1.txt").write_text("B0A1\nFFFF\nFDA3\n4E00\n")
    (d / "orphan.txt").write_text("B0A1\n")
    got = flow.generate_text_img_gt(str(d), str(tmp_path / "p.txt"))
    want = jflow.generate_text_img_gt(str(d), str(tmp_path / "j.txt"))
    assert got == want == ["B0A1", "A3FD", "4E00"]
    assert ((tmp_path / "p.txt").read_text(encoding="utf-8")
            == (tmp_path / "j.txt").read_text(encoding="utf-8"))

    m = tmp_path / "manifest.txt"
    m.write_text("".join(f"img{i}.png,{i}\n" for i in range(23)))
    test_m = tmp_path / "test_manifest.txt"
    test_m.write_text("t.png,x\n")
    for name, mod in (("port", flow), ("jax", jflow)):
        root = tmp_path / f"split_{name}"
        root.mkdir()
        mod.build_split([str(m)], str(root), val_fraction=0.2, seed=42,
                        test_manifest=str(test_m))
        mod.build_vocabulary(["B0A1", "4E00"], str(root / "chars_list.txt"))
    for f in ("train_img_id_gt.txt", "val_img_id_gt.txt",
              "test_img_id_gt.txt", "chars_list.txt"):
        assert filecmp.cmp(tmp_path / "split_port" / f,
                           tmp_path / "split_jax" / f, shallow=False), f


def test_prep_exports_gnt_and_flow_only():
    """The package exports the JAX package's tools: GNT and the flow, and
    since the DGRL and DGR tools were ported (``test_torch_prep_dgr.py``)
    those too, where the DGRL tool was absent before."""
    from handwritten_chinese_ocr_samples_torch.data.prep import dgr, dgrl
    assert prep.gnt2png is gnt.gnt2png
    assert prep.generate_char_img_gt is flow.generate_char_img_gt
    assert prep.dgrl2png is dgrl.dgrl2png
    assert prep.iter_dgrl_lines is dgrl.iter_dgrl_lines
    assert prep.dgr2png is dgr.dgr2png
