"""The port imports nothing the card's machine lacks.

That machine has torch, numpy and the CUDA toolkit, but no JAX stack, no
OpenCV or PIL, and none of the JAX package (whose ``__init__`` imports JAX).
A subprocess refuses those imports, then imports every module of the port and
``chip_smoke``. ``chip_smoke.py`` must also fail, printing no result, where
there is no card or no repository around it. The native host libraries
(``native/*.cc``) are built with the host C++ compiler; with none on
``PATH`` the build raises, and no decoder falls back to Python.
"""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "handwritten_chinese_ocr_samples_torch"
REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL",
           "handwritten_chinese_ocr_samples_tpu")

_PROBE = """
import importlib, importlib.abc, pkgutil, sys
REFUSED = {refused!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)
        return None

# a site hook may have imported some already: make those refuse too
sys.modules.update({{k: None for k in list(sys.modules)
                     if k.split(".")[0] in REFUSED}})
sys.meta_path.insert(0, Refuse())
import {port} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "{port}.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert chip_smoke.__name__ == "chip_smoke"
print("imported", len(names))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_without_jax_cv2_pil():
    code = _PROBE.format(refused=REFUSED, port=PORT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("imported")[-1])
    # lm/*, ops/* (ctc and dropout too), decode/*, data/*, eval/*, cli/*
    # (train too) and train/*
    assert n >= 51


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(_env(), CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=_env())
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_NO_COMPILER = """
import pathlib
import pytest
from handwritten_chinese_ocr_samples_torch.core.codec import CTCCodec
from handwritten_chinese_ocr_samples_torch.decode import beam_host_native
from handwritten_chinese_ocr_samples_torch.decode.beam_host import (
    BeamSearchConfig)
from handwritten_chinese_ocr_samples_torch.eval import metrics
from handwritten_chinese_ocr_samples_torch.ops import _build
_build.BUILD_DIR = pathlib.Path({tmp!r})
for call in (
        lambda: beam_host_native.try_native_host_decoder(
            CTCCodec("ab"), BeamSearchConfig(use_lm_pred=False,
                                             use_lm_score=False)),
        lambda: metrics.cer_counts(["a"], ["b"])):
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        call()
assert not list(_build.BUILD_DIR.glob("*.so"))
print("raised")
"""


def test_native_build_raises_without_a_compiler(tmp_path):
    """An empty build directory and a ``PATH`` with no ``c++``/``g++``: the
    native decoder and the edit distance raise at their first use."""
    code = _NO_COMPILER.format(tmp=str(tmp_path / "build"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(_env(), PATH=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("raised")
