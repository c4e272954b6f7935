"""The port's DGRL and DGR tools against the JAX package's.

  * ``data/prep/dgrl.py`` against the JAX package's ``data/prep/dgrl.py``
    on ``tests/test_prep_tools.py``'s pages (gray, 1-bit, zip): the parsed
    lines, and the written PNG pixels, hex labels and manifest equal; its
    resampler equal to PIL's ``Image.resize(..., LANCZOS)`` (which the JAX
    tool calls) byte for byte over a grid of sizes, up and down;
  * ``data/prep/dgr.py`` against the committed ``native/dgr2png`` binary
    (skipped only where it is absent, as ``tests/test_native.py`` skips):
    extraction and synthesis give the same files, pixel for pixel and byte
    for byte in the labels; tall lines (resized down), negative lefts,
    overlapping ink and an empty line included.
"""

import os
import subprocess
import zipfile

import cv2
import numpy as np
import pytest
from PIL import Image

from handwritten_chinese_ocr_samples_tpu.data.prep import dgrl as jax_dgrl
from handwritten_chinese_ocr_samples_torch.data.prep import dgr, dgrl

from tests.test_native import NATIVE_DIR, _write_dgr
from tests.test_prep_tools import _glyph, _write_dgrl

DGR2PNG = os.path.join(NATIVE_DIR, "dgr2png")


def _lines_equal(path):
    with open(path, "rb") as fp:
        want = list(jax_dgrl.iter_dgrl_lines(fp))
    with open(path, "rb") as fp:
        got = list(dgrl.iter_dgrl_lines(fp))
    assert [(g.text, g.top, g.left) for g in got] == \
        [(w.text, w.top, w.left) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, w.image)
    return got


def _outputs_equal(src, tmp_path, height):
    """Both tools on ``src``: the same files, PNG pixels, labels and
    manifest."""
    jout, pout = tmp_path / f"jax{height}", tmp_path / f"port{height}"
    jn, jm = jax_dgrl.dgrl2png(str(src), str(jout), height)
    pn, pm = dgrl.dgrl2png(str(src), str(pout), height)
    assert pn == jn > 0
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    for name in os.listdir(jout):
        if name.endswith(".png"):
            want = np.array(Image.open(jout / name))
            got = cv2.imread(str(pout / name), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(got, want)
        else:
            assert (pout / name).read_bytes() == (jout / name).read_bytes()
    return pout


@pytest.mark.parametrize("height", [None, 128, 64])
def test_dgrl_gray_matches_jax(tmp_path, height):
    lines = [("汉字识别测试", 20, 15, _glyph(2)),
             ("第二行文本", 120, 30, _glyph(3, h=300, w=900))]
    p = tmp_path / "page.dgrl"
    _write_dgrl(str(p), lines)
    got = _lines_equal(p)
    np.testing.assert_array_equal(got[0].image, lines[0][3])
    out = _outputs_equal(p, tmp_path, height)
    assert (out / "page-L1.txt").read_text().split() == [
        ch.encode("gb18030").hex().upper() for ch in "汉字识别测试"]


def test_dgrl_1bit_matches_jax(tmp_path):
    img = np.full((40, 100), 255, np.uint8)
    img[5:35, 5:95] = 0
    img[10:20, 3:50] = 0
    p = tmp_path / "bw.dgrl"
    _write_dgrl(str(p), [("黑白", 0, 0, img), ("二值", 50, 7, img[:, :61])],
                bits_per_pixel=1)
    got = _lines_equal(p)
    np.testing.assert_array_equal(got[0].image,
                                  np.where(img < 128, 0, 255))
    _outputs_equal(p, tmp_path, 128)


def test_dgrl_zip_input_matches_jax(tmp_path):
    _write_dgrl(str(tmp_path / "a.dgrl"), [("你好", 5, 5, _glyph(7))])
    _write_dgrl(str(tmp_path / "b.dgrl"), [("世界", 9, 1, _glyph(8)),
                                           ("再见", 3, 2, _glyph(9))])
    archive = tmp_path / "pages.zip"
    with zipfile.ZipFile(archive, "w") as z:
        z.write(tmp_path / "a.dgrl", "a.dgrl")
        z.write(tmp_path / "b.dgrl", "sub/b.DGRL")
        z.writestr("notes.txt", "not a page")
    out = _outputs_equal(archive, tmp_path, 128)
    assert (out / "dgrl_img_gt.txt").read_text(encoding="utf-8").split(
        "\n")[:3] == ["a-L1.png,你好", "b-L1.png,世界", "b-L2.png,再见"]
    jl, pl = tmp_path / "jax.lst", tmp_path / "port.lst"
    assert (dgrl.generate_file_list(str(archive), str(pl))
            == jax_dgrl.generate_file_list(str(archive), str(jl)) == 2)
    assert pl.read_text() == jl.read_text()


@pytest.mark.parametrize("h,w", [(1, 1), (3, 7), (40, 200), (60, 33),
                                 (127, 517), (129, 64), (300, 901)])
def test_lanczos_equals_pil(h, w):
    """Up- and downscaling on either axis or both, to sizes of 1 and of an
    axis left as it is; noise on white, as ink on paper."""
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    img[rng.random((h, w)) < 0.6] = 255
    for th in (1, 16, 128, 2 * h + 1):
        for tw in (1, max(1, int(w * th / h)), w, 3 * w + 2):
            want = np.array(Image.fromarray(img).resize(
                (tw, th), Image.Resampling.LANCZOS))
            got = dgrl.lanczos_resize(img, tw, th)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{th}x{tw}")
    want = jax_dgrl.resize_to_height(img, 128)
    np.testing.assert_array_equal(dgrl.resize_to_height(img, 128), want)


# ---------------------------------------------------------------- DGR
def _page_set(root, seed=0):
    """Three seeded DGR pages (a list file): words of random ink at random
    offsets, tall lines, a negative left, overlaps and an empty line; and
    a seeded HWDB1.x-style glyph csv with an alpha/symbol list."""
    rng = np.random.default_rng(seed)

    def bitmap(h, w):
        g = np.full((h, w), 255, np.uint8)
        ink = rng.random((h, w)) < 0.4
        g[ink] = rng.integers(0, 200, int(ink.sum()))
        return g

    pages = []
    for p in range(3):
        lines = []
        for _ in range(4):
            words, x = [], int(rng.integers(-5, 30))
            for _ in range(int(rng.integers(1, 6))):
                h, w = int(rng.integers(20, 160)), int(rng.integers(10, 90))
                hx = ("B0A1", "A3A1", "C5F7", "A1A2")[int(rng.integers(0, 4))]
                words.append((hx, int(rng.integers(40, 120)), x,
                              bitmap(h, w)))
                x += w - int(rng.integers(0, 15))
            lines.append(words)
        lines.append([])
        path = os.path.join(root, f"page{p}.dgr")
        _write_dgr(path, lines)
        pages.append(path)
    lst = os.path.join(root, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(pages) + "\n")
    os.makedirs(os.path.join(root, "glyphs"))
    rows = []
    for i in range(23):
        path = os.path.join(root, "glyphs", f"g{i}.png")
        cv2.imwrite(path, bitmap(int(rng.integers(30, 90)),
                                 int(rng.integers(30, 90))))
        rows.append(f"{path},B{0xA1 + i:X}0")
    gt = os.path.join(root, "gt.csv")
    with open(gt, "w") as f:
        f.write("\n".join(rows) + "\n")
    alpha = os.path.join(root, "alpha.txt")
    with open(alpha, "w") as f:
        f.write("A3A1\nA1A2\n")
    return lst, gt, alpha


@pytest.mark.skipif(not os.path.exists(DGR2PNG), reason="dgr2png not built")
@pytest.mark.parametrize("mode", ["extract", "synthesize"])
def test_dgr_matches_native_binary(tmp_path, mode):
    lst, gt, alpha = _page_set(str(tmp_path))
    extra = [] if mode == "extract" else [gt, alpha]
    want, got = tmp_path / "native", tmp_path / "port"
    want.mkdir()
    got.mkdir()
    r = subprocess.run([DGR2PNG, lst, str(want), *extra],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert dgr.main([lst, str(got), *extra]) == 0
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    pngs = [n for n in names if n.endswith(".png")]
    assert len(pngs) == (12 if mode == "extract" else 22)
    for name in names:
        if name.endswith(".png"):
            w = cv2.imread(str(want / name), cv2.IMREAD_UNCHANGED)
            g = cv2.imread(str(got / name), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert g.shape[0] == 128
        else:
            assert (got / name).read_bytes() == (want / name).read_bytes()
    if mode == "synthesize":
        # two passes, the second cut short where the 23 glyphs ran out
        assert any(n.endswith("-S2.png") for n in pngs)
        assert not any(n.endswith("-S3.png") for n in pngs)


def test_dgr_cli_errors(tmp_path, capsys):
    lst = tmp_path / "list.txt"
    lst.write_text("")
    assert dgr.main([str(lst)]) == 1
    assert dgr.main([str(lst), str(tmp_path / "missing")]) == 1
    assert dgr.main([str(lst), str(tmp_path), str(tmp_path / "no.csv"),
                     str(tmp_path / "alpha")]) == 1
    assert dgr.main([str(lst), str(tmp_path)]) == 0
    assert "does not exist" in capsys.readouterr().err


def test_dgr_synthesis_ends_without_replaceable_words(tmp_path):
    """Every word on the alpha/symbol list: the C++ tool would pass over
    the pages forever; the port stops after the first pass."""
    g = np.full((30, 30), 255, np.uint8)
    g[5:25, 5:25] = 9
    page = tmp_path / "p.dgr"
    _write_dgr(str(page), [[("A3A1", 10, 10, g)]])
    lst = tmp_path / "list.txt"
    lst.write_text(f"{page}\n")
    gt = tmp_path / "gt.csv"
    gt.write_text(f"{tmp_path / 'x.png'},D2BB\n")
    alpha = tmp_path / "alpha.txt"
    alpha.write_text("A3A1\n")
    out = tmp_path / "out"
    out.mkdir()
    assert dgr.main([str(lst), str(out), str(gt), str(alpha)]) == 0
    assert sorted(os.listdir(out)) == ["p-L1-S1.png", "p-L1-S1.txt"]
