"""The port's serving path (ServingEngine, ServingDaemon, cli.deploy) against
the JAX package's, on the same images and converted weights.

Weights: the committed ``demo/checkpoint`` (hctr-tiny), read on the test
side with the JAX package's ``restore_pytree_host`` and converted with
``flax_to_torch``. Served texts must be identical on the greedy and the
device-beam route, and on the host beam's no-LM routes. Everything runs on
the CPU.
"""

import io
import os
import sys
import threading
from concurrent.futures import CancelledError

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_synth import make_dataset

from handwritten_chinese_ocr_samples_tpu.core.codec import (
    CTCCodec as JaxCodec)
from handwritten_chinese_ocr_samples_tpu.models.hctr import (
    HCTRModel as FlaxHCTR)
from handwritten_chinese_ocr_samples_tpu.serve.engine import (
    ServingEngine as JaxEngine, _pad_fixed_shape)
from handwritten_chinese_ocr_samples_tpu.utils.ckpt_io import (
    restore_pytree_host)
from handwritten_chinese_ocr_samples_torch.cli import deploy
from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
from handwritten_chinese_ocr_samples_torch.decode.lm_interface import NullLM
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.serve.daemon import ServingDaemon
from handwritten_chinese_ocr_samples_torch.serve.engine import (
    ServingEngine, _resize_area)
from handwritten_chinese_ocr_samples_torch.utils.weights import flax_to_torch

from tests.test_torch_lm import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo")
CHARS = os.path.join(DEMO, "data", "chars_list.txt")
WIDTHS = (64, 128)
BEAM = dict(beam_size=4, search_depth=5, len_bonus=1.0)
NGRAM = os.path.join(REPO, "demo", "hard", "lm", "ngram.hblm")


@pytest.fixture(scope="module")
def demo():
    payload = restore_pytree_host(os.path.join(DEMO, "checkpoint"))
    variables = {"params": payload["params"],
                 "batch_stats": payload["batch_stats"]}
    test_dir = os.path.join(DEMO, "data", "test")
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))]
    return variables, files[:6]


def _jax_engine(variables, method, dtype=jnp.float32, widths=WIDTHS,
                beam=BEAM, int8=False, **extra):
    with open(CHARS, encoding="utf-8") as f:
        codec = JaxCodec("".join(line.strip("\n") for line in f))
    model = FlaxHCTR(num_classes=codec.num_classes, backbone_channels=64,
                     num_blocks=(1, 1, 1, 1), dtype=dtype)
    kw = dict(beam, **extra) if method == "beam-search" else {}
    return JaxEngine(model, variables, codec, widths=widths,
                     decode_method=method, int8=int8, **kw)


def _port_engine(variables, method, widths=WIDTHS):
    model, chars = get_model_info("hctr-tiny", chars_list_file=CHARS)
    kw = BEAM if method == "beam-search" else {}
    return ServingEngine(model, flax_to_torch(variables), CTCCodec(chars),
                         widths=widths, decode_method=method, device="cpu",
                         **kw)


@pytest.mark.parametrize("method", ["greedy-search", "beam-search"])
def test_engine_matches_jax(demo, method):
    variables, files = demo
    want, _ = _jax_engine(variables, method).infer_files(files)
    engine = _port_engine(variables, method)
    arrays = [cv2.imread(f, cv2.IMREAD_GRAYSCALE) for f in files]
    assert engine.infer_files(files)[0] == want
    assert engine.infer_files_batched(files, batch_size=4)[0] == want
    assert engine.infer_arrays(arrays, batch_size=4)[0] == want
    assert all(want)                  # the trained demo reads every line


def record_batches(log: list, dispatch):
    """``dispatch`` (a batch's outputs -> ``finalize``) wrapped to append
    ``("dispatch", k)`` when batch k is dispatched and ``("finalize", k)``
    when its host tail runs."""
    def wrapped(outputs):
        k = sum(e[0] == "dispatch" for e in log)
        log.append(("dispatch", k))
        finalize = dispatch(outputs)

        def recorded():
            log.append(("finalize", k))
            return finalize()
        return recorded
    return wrapped


@pytest.mark.parametrize("method", ["greedy-search", "beam-search"])
def test_batched_overlap_matches_jax(demo, method):
    """One batch in flight: on both width buckets with a ragged last batch
    (batches of 2, 3 and 1), the port's ``infer_files_batched`` serves the
    JAX engine's texts, and both engines dispatch batch k+1 before they run
    batch k's host tail."""
    variables, files = demo
    jax_engine = _jax_engine(variables, method)
    want_log, got_log = [], []
    jax_engine._decode_outputs_async = record_batches(
        want_log, jax_engine._decode_outputs_async)
    want, _ = jax_engine.infer_files_batched(files, batch_size=3)
    engine = _port_engine(variables, method)
    engine.route.dispatch = record_batches(got_log, engine.route.dispatch)
    assert engine.infer_files_batched(files, batch_size=3)[0] == want
    assert got_log == want_log == [
        ("dispatch", 0), ("dispatch", 1), ("finalize", 0), ("dispatch", 2),
        ("finalize", 1), ("finalize", 2)]


@pytest.mark.parametrize("height", [96, 160])
def test_resized_input_matches_jax(demo, height):
    """Lines not at model height are area-resized (numpy here, OpenCV in the
    JAX package) before padding; the served texts agree."""
    variables, files = demo
    arrays = []
    for f in files[:4]:
        img = cv2.imread(f, cv2.IMREAD_GRAYSCALE)
        w = int(round(img.shape[1] * height / img.shape[0]))
        arrays.append(cv2.resize(img, (w, height),
                                 interpolation=cv2.INTER_AREA))
    jax_engine = _jax_engine(variables, "greedy-search")
    want = []
    for a in arrays:
        true_w = int(128 * a.shape[1] / a.shape[0])
        x = _pad_fixed_shape(a, 128, jax_engine.bucket_for(true_w))
        out = jax_engine._exe(1, x.shape[2])(jax_engine.variables,
                                             jnp.asarray(x))
        want.append(jax_engine._decode_outputs(out)[0])
    got, _ = _port_engine(variables, "greedy-search").infer_arrays(arrays)
    assert got == want


@pytest.mark.parametrize("shape,size", [
    ((128, 300), (64, 150)), ((100, 77), (128, 98)), ((256, 512), (128, 256)),
    ((60, 200), (128, 426))])
def test_resize_area_matches_opencv(shape, size):
    """Within one gray level of ``cv2.resize(INTER_AREA)``: OpenCV rounds
    its fixed-point sums differently."""
    src = np.random.default_rng(sum(shape)).integers(
        0, 256, size=shape).astype(np.uint8)
    want = cv2.resize(src, (size[1], size[0]), interpolation=cv2.INTER_AREA)
    got = _resize_area(src, *size)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_host_beam_and_int8_engines_match_jax(demo):
    """The host-beam configurations build the host beam and serve the JAX
    engine's texts; int8 serving calibrates on the first batch and serves
    the JAX int8 engine's texts."""
    variables, files = demo
    model, chars = get_model_info("hctr-tiny", chars_list_file=CHARS)
    sd = flax_to_torch(variables)
    for kw in (dict(use_lm_score=True), dict(lm=NullLM(), use_lm_pred=True),
               dict(skip_search=True)):
        engine = ServingEngine(model, sd, CTCCodec(chars), device="cpu",
                               widths=WIDTHS, decode_method="beam-search",
                               **BEAM, **kw)
        assert engine._host_beam is not None
        want, _ = _jax_engine(variables, "beam-search", **kw).infer_files(
            files)
        assert engine.infer_files(files)[0] == want
    engine = ServingEngine(model, sd, CTCCodec(chars), device="cpu",
                           widths=WIDTHS, decode_method="beam-search",
                           int8=True, **BEAM)
    assert engine._quant is None
    want, _ = _jax_engine(variables, "beam-search",
                          int8=True).infer_files(files)
    assert engine.infer_files(files)[0] == want
    assert len(engine._quant) == 17


@pytest.fixture(scope="module")
def greedy_engine(demo):
    return _port_engine(demo[0], "greedy-search")


def test_daemon_concurrent_requests_match(demo, greedy_engine):
    files = demo[1]
    want = dict(zip(files, greedy_engine.infer_files(files)[0]))
    results, errors = {}, []
    daemon = ServingDaemon(greedy_engine, batch_size=4, max_delay_ms=30)

    def client(i):
        f = files[i % len(files)]
        try:
            results[i] = (f, daemon.submit(f).result(timeout=120))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    daemon.close()
    assert not errors and len(results) == 10
    assert all(text == want[f] for f, text in results.values())


def test_daemon_deadline_flush_drain_and_cancel(demo, greedy_engine):
    files = demo[1]
    img = cv2.imread(files[0], cv2.IMREAD_GRAYSCALE)
    want = greedy_engine.infer_files(files[:1])[0][0]
    with ServingDaemon(greedy_engine, batch_size=4,
                       max_delay_ms=20) as daemon:
        # one request never fills the batch; the deadline flushes it
        assert daemon.submit_array(img).result(timeout=120) == want
    daemon = ServingDaemon(greedy_engine, batch_size=4, max_delay_ms=60_000)
    futs = [daemon.submit(f) for f in files[:3]]
    daemon.close()                       # drains the partial batch
    assert [f.result(timeout=1) for f in futs] == \
        greedy_engine.infer_files(files[:3])[0]
    with pytest.raises(RuntimeError):
        daemon.submit(files[0])
    daemon = ServingDaemon(greedy_engine, batch_size=4, max_delay_ms=60_000)
    fut = daemon.submit(files[0])
    daemon.close(drain=False)
    with pytest.raises(CancelledError):
        fut.result(timeout=1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory, demo):
    """A tmp folder of PNGs made with tests/util_synth.py, and the demo
    weights saved as a torch state dict."""
    root = str(tmp_path_factory.mktemp("torch_serve"))
    make_dataset(root, n_train=0, n_val=0, n_test=5, seed=3)
    pt = os.path.join(root, "demo.pt")
    torch.save(flax_to_torch(demo[0]), pt)
    test_dir = os.path.join(root, "test")
    return root, test_dir, pt


@pytest.mark.parametrize("method", ["greedy-search", "beam-search"])
@pytest.mark.parametrize("mode", [[], ["-b", "2"], ["-b", "2", "--daemon"]])
def test_cli_deploy_matches_jax(demo, synth, method, mode):
    root, test_dir, pt = synth
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))]
    want, _ = _jax_engine(demo[0], method, dtype=jnp.bfloat16,
                          widths=(128,)).infer_files(files)
    extra = (["-bs", "4", "-sd", "5", "-lb", "1.0"]
             if method == "beam-search" else [])
    got = deploy.main(["-lang", "hctr-tiny", "-m", pt, "-i", test_dir,
                       "-cl", CHARS, "-w", "128", "-d", "cpu", "-dm", method,
                       *extra, *mode])
    assert got == want


def test_cli_deploy_stdin_and_seed_weights(synth, monkeypatch, capsys):
    root, test_dir, _ = synth
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))]
    missing = os.path.join(test_dir, "missing.png")
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(files + [missing])))
    deploy.main(["-lang", "hctr-tiny", "-m", "seed:0", "-i", test_dir,
                 "-cl", CHARS, "-w", "128", "-d", "cpu", "--daemon",
                 "--stdin", "-b", "2", "--max-delay-ms", "20"])
    out = capsys.readouterr().out
    got = dict(line.split("\t", 1) for line in out.splitlines()
               if "\t" in line)
    assert set(got) == set(files) | {missing}
    assert got[missing].startswith("ERROR")
    assert not any(got[f].startswith("ERROR") for f in files)


@pytest.mark.parametrize("flag", [["-dm", "beam-search", "-ss"], ["-uts"],
                                  ["-kp", NGRAM], ["--int8"],
                                  ["--lm-int8"]])
def test_cli_deploy_unported_flags_error(demo, synth, flag, capsys):
    """The flags once refused, the host beam's and the int8 ones, now serve
    the JAX engine's texts for the same flags (``-uts`` and ``-kp`` without
    a beam search leave greedy as it is, and so does ``--lm-int8`` without
    the LM-fused search); ``--int8`` calibrates on the first request's
    batch and prints the one-liner."""
    _, test_dir, pt = synth
    argv = ["-m", pt, "-i", test_dir, "-lang", "hctr-tiny", "-cl", CHARS,
            "-w", "128", "-d", "cpu", *flag]
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))]
    method = "beam-search" if "beam-search" in flag else "greedy-search"
    want, _ = _jax_engine(demo[0], method, dtype=jnp.bfloat16, widths=(128,),
                          beam={}, skip_search="-ss" in flag,
                          int8="--int8" in flag).infer_files(files)
    assert deploy.main(argv) == want
    assert ("[int8] calibrated 17 conv sites" in capsys.readouterr().out) \
        == ("--int8" in flag)
