"""The port's eval slice against the JAX package's, on the CPU.

* Data pipeline on demo/hard's 150 test images: ``data/dataset`` arrays,
  ``AlignCollate`` batches and ``DataLoader`` batches equal JAX's exactly,
  and the widths the loader reads from the PNG header equal PIL's.
* ``eval/metrics``: ``cer_counts`` exact, native and numpy.
* ``cli/test.py -bm`` on a 16-line copy of the test split, the way a user
  runs it (bf16 recognizer): it prints a CER that parses, equal to the CER of
  its own texts; its texts equal the JAX eval CLI's committed texts
  (``assets/demo_hard/texts.json``, ``eval``) but at the lines named in
  ``NEAR_TIES``, each of which the test shows to be a bf16 near-tie. With
  the recognizer in f32 on both sides the texts are equal everywhere.
* ``-gs`` on a 2x2 grid over 8 lines picks JAX's pair; single-image mode
  prints JAX's texts; ``--profile`` traces a run, reference ``.pth``/
  ``.pth.tar`` files load; the surfaces not ported stop with an error that
  names their ROADMAP item.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from handwritten_chinese_ocr_samples_tpu.cli import test as jax_cli
from handwritten_chinese_ocr_samples_tpu.data import bucketing as jb
from handwritten_chinese_ocr_samples_tpu.data import dataset as jd
from handwritten_chinese_ocr_samples_tpu.data import loader as jl
from handwritten_chinese_ocr_samples_tpu.eval import driver as jdriver
from handwritten_chinese_ocr_samples_tpu.eval import metrics as jmetrics
from handwritten_chinese_ocr_samples_tpu.models import registry as jreg
from handwritten_chinese_ocr_samples_torch.cli import test as port_cli
from handwritten_chinese_ocr_samples_torch.data import bucketing as pb
from handwritten_chinese_ocr_samples_torch.data import dataset as pd
from handwritten_chinese_ocr_samples_torch.data import loader as pl
from handwritten_chinese_ocr_samples_torch.eval import metrics as pmetrics
from handwritten_chinese_ocr_samples_torch.models import registry as preg
from tools import convert_to_torch as conv

from tests.test_torch_lm import one_torch_thread  # noqa: F401

DATA = os.path.join(conv.DEMO, "data")
WEIGHTS = os.path.join(conv.OUT, "hctr_tiny.pt")
LM = os.path.join(conv.OUT, "lm")
N_LINES = 16
# Lines of the 16 whose bf16 texts differ between the two backends (XLA
# keeps excess precision in bf16 chains), by command;
# test_named_near_ties_are_bf16_near_ties shows each is a near-tie.
NEAR_TIES = {"greedy": (1,), "lm_ss": (), "ngram_ss": ()}


@pytest.fixture(scope="module")
def committed():
    with open(os.path.join(conv.OUT, "texts.json"), encoding="utf-8") as f:
        return json.load(f)["eval"]


def _split(root, n):
    """A copy of demo/hard's test split cut to its first ``n`` lines."""
    os.makedirs(os.path.join(root, "test"))
    shutil.copy(os.path.join(DATA, "chars_list.txt"), root)
    with open(os.path.join(DATA, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        lines = [line for line in f if line.strip()][:n]
    with open(os.path.join(root, "test_img_id_gt.txt"), "w",
              encoding="utf-8") as f:
        f.writelines(lines)
    for line in lines:
        name = line.split(",", 1)[0]
        shutil.copy(os.path.join(DATA, "test", name),
                    os.path.join(root, "test"))
    return str(root)


@pytest.fixture(scope="module")
def split16(tmp_path_factory):
    return _split(tmp_path_factory.mktemp("split16"), N_LINES)


def _port_eval(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = port_cli.main(argv)
    return result, buf.getvalue()


@pytest.fixture
def f32_recognizers(monkeypatch):
    """Both packages' eval with the recognizer in f32 instead of bf16."""
    jget, pget = jreg.get_model_info, preg.get_model_info
    monkeypatch.setattr(jreg, "get_model_info", lambda *a, **k: jget(
        *a, **dict(k, dtype=jnp.float32)))
    monkeypatch.setattr(preg, "get_model_info", lambda *a, **k: pget(
        *a, **dict(k, dtype=torch.float32)))


def _jax_eval(argv):
    jax.config.update("jax_platforms", "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jdriver.run_benchmark(jax_cli.build_argparser().parse_args(argv))
    return conv.parse_eval_output(buf.getvalue())


# ------------------------------------------------------------ data pipeline
@pytest.fixture(scope="module")
def test_files():
    ds = pd.ImageDataset(DATA, (1, 128), "test")
    assert ds.data_list == jd.ImageDataset(DATA, (1, 128), "test").data_list
    return [p for p, _ in ds.data_list]


def test_images_equal_jax(test_files):
    assert len(test_files) == 150
    for path in test_files:
        got = pd.load_and_resize_image(path, 128)
        want = jd.load_and_resize_image(path, 128)
        assert got.dtype == np.uint8 and np.array_equal(got, want), path
        assert np.array_equal(pd.read_resize_image(path, 128),
                              jd.read_resize_image(path, 128)), path


def test_unusual_png_raises_naming_the_file(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.full((32, 64), 40000, np.uint16))
    assert jd.load_and_resize_image(path, 16).shape[0] == 16   # PIL there
    with pytest.raises(ValueError, match="deep.png"):
        pd.load_and_resize_image(path, 16)


@pytest.mark.parametrize("bucketed", [False, True])
def test_collate_equals_jax(test_files, bucketed):
    images = [pd.load_and_resize_image(p, 128) for p in test_files[:24]]
    labels = [str(i) * (i % 7 + 1) for i in range(24)]
    ours = pb.AlignCollate(max_width=200, bucket_spec=pb.BucketSpec()
                           if bucketed else None)
    ref = jb.AlignCollate(max_width=200, bucket_spec=jb.BucketSpec()
                          if bucketed else None)
    for s in range(0, 24, 8):
        batch = list(zip(images[s:s + 8], labels[s:s + 8]))
        got, want = ours(batch), ref(batch)
        assert got["labels"] == want["labels"]
        for key in ("images", "widths"):
            assert got[key].dtype == want[key].dtype
            assert np.array_equal(got[key], want[key])
    assert pb.default_buckets(1000, 256) == jb.default_buckets(1000, 256)


@pytest.mark.parametrize("group,shuffle", [(False, False), (True, False),
                                           (True, True)])
def test_loader_batches_equal_jax(group, shuffle):
    def batches(mb, md, ml):
        ds = md.ImageDataset(DATA, (1, 128), "test", batch_size=8)
        col = mb.AlignCollate(bucket_spec=mb.BucketSpec())
        loader = ml.DataLoader(ds, 8, col, shuffle=shuffle, seed=3,
                               group_by_width=group, num_workers=2,
                               shard_id=1, num_shards=2)
        loader.set_epoch(1)
        return list(loader)
    got, want = (batches(pb, pd, pl), batches(jb, jd, jl))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g["labels"] == w["labels"]
        assert np.array_equal(g["images"], w["images"])


def test_header_widths_equal_pil(test_files):
    for path in test_files:
        with Image.open(path) as im:
            assert pl.image_size(path) == im.size, path
    ds = pd.ImageDataset(DATA, (1, 128), "test", batch_size=8)
    ref = jd.ImageDataset(DATA, (1, 128), "test", batch_size=8)
    col = pb.AlignCollate()
    assert np.array_equal(pl.DataLoader(ds, 8, col)._item_widths(),
                          jl.DataLoader(ref, 8, col)._item_widths())


# ------------------------------------------------------------------ metrics
def test_cer_counts_exact_native_and_numpy():
    rng = np.random.default_rng(0)
    alphabet = list("abcd中文字符") + ["😀"]
    pairs = [("", ""), ("", "abc"), ("abc", ""), ("kitten", "sitting")]
    for _ in range(200):
        a = "".join(rng.choice(alphabet, int(rng.integers(0, 14))))
        b = "".join(rng.choice(alphabet, int(rng.integers(0, 14))))
        pairs.append((a, b))
    preds, truths = zip(*pairs)
    want = jmetrics.cer_counts(preds, truths)
    assert pmetrics.cer_counts(preds, truths) == want
    numpy_dist = 0
    for a, b in pairs:
        d = jmetrics.levenshtein(a, b)
        assert pmetrics.levenshtein(a, b) == d
        numpy_dist += pmetrics._levenshtein_np(pmetrics.codepoints(a),
                                               pmetrics.codepoints(b))
    assert numpy_dist == want[0]
    meter, ref = pmetrics.AverageMeter("cer"), jmetrics.AverageMeter("cer")
    for v, n in ((0.5, 2), (0.25, 6)):
        meter.update(v, n)
        ref.update(v, n)
    assert str(meter) == str(ref) and meter.avg == ref.avg


# ----------------------------------------------------------------- eval CLI
@pytest.mark.parametrize("name", list(conv.EVAL_COMMANDS))
def test_eval_cli_matches_jax_texts(split16, committed, name):
    cer, out = _port_eval(conv.eval_argv(name, WEIGHTS, split16, LM)
                          + ["-d", "cpu"])
    texts, printed = conv.parse_eval_output(out)
    assert printed == cer
    with open(os.path.join(split16, "test_img_id_gt.txt"),
              encoding="utf-8") as f:
        labels = [line.rstrip("\n").split(",", 1)[1] for line in f]
    dist, total = pmetrics.cer_counts(texts, labels)
    assert len(texts) == N_LINES and cer == dist / total
    want = committed[name]["texts"][:N_LINES]
    differ = tuple(i for i, (a, b) in enumerate(zip(texts, want)) if a != b)
    assert differ == NEAR_TIES[name], [(i, texts[i], want[i])
                                       for i in differ]


@pytest.mark.parametrize("name", ["greedy", "ngram_ss"])
def test_eval_cli_f32_equals_jax(split16, f32_recognizers, name):
    want, want_cer = _jax_eval(conv.eval_argv(
        name, os.path.join(conv.DEMO, "checkpoint"), split16,
        os.path.join(conv.DEMO, "lm")))
    cer, out = _port_eval(conv.eval_argv(name, WEIGHTS, split16, LM)
                          + ["-d", "cpu"])
    assert conv.parse_eval_output(out) == (want, want_cer) and cer == want_cer


@pytest.mark.parametrize("flags", [
    [], ["-ss"], ["-uts"], ["-utp", "-ss"], ["--host-beam"],
    ["-utp", "-uts", "-tp", "LM"], ["-utp", "-uts", "-tp", "LM", "-ss"],
    ["-utp", "-tp", "LM"], ["-uts", "-tp", "LM", "--host-beam"],
    ["-kp", "NGRAM"], ["-ss", "-kp", "NGRAM"],
    ["-utp", "-tp", "LM", "-kp", "NGRAM"]])
def test_eval_routes_as_the_jax_driver(split16, flags):
    """The eval driver picks the JAX driver's route for each set of flags:
    device beam, LM-fused device search or host beam; on the host beam with
    an LM, the same LM, scoring and proposals."""
    subst = {"LM": (LM, os.path.join(conv.DEMO, "lm")),
             "NGRAM": (conv.NGRAM, conv.NGRAM)}
    common = ["-m", "hctr-tiny", "-i", split16, "-bm", "-dm", "beam-search"]
    port_args = port_cli.build_argparser().parse_args(
        common + ["-f", WEIGHTS, "-d", "cpu"]
        + [subst[f][0] if f in subst else f for f in flags])
    jax.config.update("jax_platforms", "cpu")
    jax_args = jax_cli.build_argparser().parse_args(
        common + ["-f", os.path.join(conv.DEMO, "checkpoint")]
        + [subst[f][1] if f in subst else f for f in flags])
    from handwritten_chinese_ocr_samples_torch.eval import driver as pdriver
    route = pdriver.EvalSession(port_args).route
    want = jdriver.EvalSession(jax_args)
    assert route.name == ("beam" if want.device_beam else "lm"
                          if want.device_lm_beam else "host")
    lm = getattr(want.beam, "lm", None)
    if route.name == "host" and type(lm).__name__ != "NullLM":
        cfg = route.host.cfg
        assert (cfg.use_lm_score, cfg.use_lm_pred, cfg.skip_search) == (
            want.beam.cfg.use_lm_score, want.beam.cfg.use_lm_pred,
            want.beam.cfg.skip_search)
        assert type(route.host).__name__ == type(want.beam).__name__


def test_grid_search_picks_jax_pair(tmp_path, monkeypatch):
    split8 = _split(tmp_path / "split8", 8)
    grid = ["-gs", "-al", "0.0", "-au", "0.8", "-ac", "2", "-bl", "0.0",
            "-bu", "4.0", "-bc", "2"]
    argv = conv.eval_argv("ngram_ss", WEIGHTS, split8, LM) + grid
    best, _ = _port_eval(argv + ["-d", "cpu"])
    jax.config.update("jax_platforms", "cpu")
    jargv = conv.eval_argv("ngram_ss", os.path.join(conv.DEMO, "checkpoint"),
                           split8, os.path.join(conv.DEMO, "lm")) + grid
    monkeypatch.setattr(sys, "argv", ["test.py", *jargv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_cli.main()
    line = [s for s in buf.getvalue().splitlines() if s.startswith("best:")]
    pair = [float(kv.split("=")[1]) for kv in line[-1].split()[1:3]]
    assert [float(best[0]), float(best[1])] == pair
    assert best[2] < 0.5


def test_single_mode_prints_jax_texts(split16, f32_recognizers, capsys):
    folder = os.path.join(split16, "test")
    argv = ["-m", "hctr-tiny", "-i", folder, "-b", "4", "-dm",
            "greedy-search", "-cl", os.path.join(split16, "chars_list.txt")]
    jax.config.update("jax_platforms", "cpu")
    jdriver.run_single(jax_cli.build_argparser().parse_args(
        argv + ["-f", os.path.join(conv.DEMO, "checkpoint")]))
    want = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith(("file:", "pred:"))]
    assert port_cli.main(argv + ["-f", WEIGHTS, "-d", "cpu"]) is None
    got = [s for s in capsys.readouterr().out.splitlines()
           if s.startswith(("file:", "pred:"))]
    assert got == want and len(got) == 2 * N_LINES


@pytest.mark.parametrize("flags", [
    ["-dp", "2"], ["-b", "8", *conv.INT8_EVAL_COMMANDS["greedy"]],
    ["-b", "8", *conv.INT8_EVAL_COMMANDS["lm_ss"]]])
def test_unported_flags_error(split16, committed, flags, capsys):
    """The surfaces not ported stop with an error that names their ROADMAP
    item; none is left. ``--int8`` and ``--lm-int8``, refused until int8
    was ported, now run (on RESULTS.md's greedy and LM ``-ss`` commands):
    the 17-site one-liner, and a CER within 0.02 of the float command's
    (the JAX eval's texts on the same lines). ``-dp``, refused until
    multi-device eval was ported, now runs: at ``-b 1`` it stops with the
    JAX driver's message, at ``-b 8`` it gives the unsharded CER
    (``tests/test_torch_dp_eval.py`` holds it to JAX's ``-dp``).
    ``--profile`` and reference ``.pth``/``.pth.tar`` files, refused until
    they were ported, are ``test_profile_and_reference_checkpoints``'s."""
    argv = ["-m", "hctr-tiny", "-f", WEIGHTS, "-i", split16, "-bm", "-d",
            "cpu", *[LM if f == "LM" else f for f in flags]]
    if "-dp" in flags:
        with pytest.raises(ValueError, match="--data-parallel 2 must "
                                             "divide the batch size 1"):
            port_cli.main(argv)
        greedy = argv + ["-b", "8", "-dm", "greedy-search"]
        want, _ = _port_eval([a for a in greedy if a not in ("-dp", "2")])
        cer, _ = _port_eval(greedy)
        assert cer == want
        return
    if "--int8" in flags:
        cer, out = _port_eval(argv)
        assert ("[int8] calibrated 17 conv sites; serving s8xs8->s32 convs"
                in out)
        name = "lm_ss" if "--lm-int8" in flags else "greedy"
        with open(os.path.join(split16, "test_img_id_gt.txt"),
                  encoding="utf-8") as f:
            labels = [line.rstrip("\n").split(",", 1)[1] for line in f]
        dist, total = pmetrics.cer_counts(
            committed[name]["texts"][:N_LINES], labels)
        assert cer <= dist / total + 0.02
        return
    with pytest.raises(SystemExit) as e:
        port_cli.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP.md queue 1, item" in err


@pytest.fixture(scope="module")
def greedy16(split16):
    """``-bm -tv -b 8 -dm greedy-search`` on the 16 lines with
    ``hctr_tiny.pt``: (CER, the PRE/TRU lines)."""
    cer, out = _port_eval(["-m", "hctr-tiny", "-f", WEIGHTS, "-i", split16,
                           "-bm", "-d", "cpu", "-b", "8", "-dm",
                           "greedy-search", "-tv"])
    return cer, [s for s in out.splitlines() if s.startswith(("PRE", "TRU"))]


@pytest.mark.parametrize("flags", [
    ["--profile", "trace"], ["-f", "x.pth"], ["-f", "x.pth.tar"]])
def test_profile_and_reference_checkpoints(split16, greedy16, flags,
                                           tmp_path):
    """``--profile DIR`` writes a ``torch.profiler`` trace of the run into
    DIR, at the unprofiled run's CER and texts; ``-f`` a reference
    ``.pth`` (a bare state dict) or ``.pth.tar`` (the reference's training
    checkpoint, under DDP's ``module.``), built here from the same weights
    in the reference's layout, gives the texts of ``-f hctr_tiny.pt``."""
    from tests.torch_reference_layout import reference_state_dict
    argv = ["-m", "hctr-tiny", "-i", split16, "-bm", "-d", "cpu", "-b", "8",
            "-dm", "greedy-search", "-tv"]
    if flags[0] == "--profile":
        trace = str(tmp_path / "trace")
        argv += ["-f", WEIGHTS, "--profile", trace]
    else:
        ref = reference_state_dict(torch.load(WEIGHTS, weights_only=True))
        path = str(tmp_path / flags[1])
        torch.save(ref if path.endswith(".pth") else {
            "epoch": 3, "best_acc": 0.9, "optimizer": {},
            "state_dict": {f"module.{k}": v for k, v in ref.items()}}, path)
        argv += ["-f", path]
    cer, out = _port_eval(argv)
    assert cer == greedy16[0]
    assert [s for s in out.splitlines()
            if s.startswith(("PRE", "TRU"))] == greedy16[1]
    if flags[0] == "--profile":
        assert f"profiler trace -> {trace}" in out
        files = os.listdir(trace)
        assert len(files) == 1 and files[0].endswith(".pt.trace.json")
        with open(os.path.join(trace, files[0])) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "aten::convolution" in names


def test_classifier_is_refused_naming_the_trainer(split16):
    """The JAX eval CLI takes ``-m innovation`` and fails in its greedy
    decode on the classifier's ``(B, classes)`` logits; the port stops
    before loading, naming ``cli/train.py --test``, the JAX package's one
    classifier eval."""
    with pytest.raises(ValueError, match="cli/train.py -m innovation --test"):
        port_cli.main(["-m", "innovation", "-f", "seed:0", "-i", split16,
                       "-bm", "-d", "cpu"])


def test_named_near_ties_are_bf16_near_ties(split16):
    """Each line of ``NEAR_TIES`` has a frame where the f32 logits' top two
    are closer than the bf16 forwards move them (the larger of the two
    packages' deviations from f32, twice): there the argmax, and so the
    search, may go either way."""
    named = sorted({i for lines in NEAR_TIES.values() for i in lines})
    assert named
    ds = pd.ImageDataset(split16, (1, 128), "test", batch_size=8)
    col = pb.AlignCollate(bucket_spec=pb.BucketSpec())
    jm = jreg.get_model_info("hctr-tiny", data_dir=split16,
                             dtype=jnp.bfloat16)[0]
    jvars = jdriver.load_recognizer_variables(
        os.path.join(conv.DEMO, "checkpoint"))
    state = torch.load(WEIGHTS, weights_only=True)
    for i in named:
        b = i // 8
        batch = col([ds[j] for j in range(8 * b, 8 * b + 8)])["images"]
        logits = {}
        for dt in (torch.float32, torch.bfloat16):
            model = preg.get_model_info("hctr-tiny", data_dir=split16,
                                        dtype=dt)[0]
            model.load_state_dict(state)
            with torch.inference_mode():
                logits[dt] = model.eval()(torch.from_numpy(batch))[i % 8]
        f32 = logits[torch.float32].numpy()
        jbf = np.asarray(jm.apply(
            jvars, jnp.asarray(batch), train=False), np.float32)[i % 8]
        dev = max(np.abs(jbf - f32).max(),
                  np.abs(logits[torch.bfloat16].numpy() - f32).max())
        top2 = np.sort(f32, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() < 2 * dev, i
