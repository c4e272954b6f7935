"""The port imports nothing the card's machine lacks.

That machine has torch, numpy and the CUDA toolkit, but no JAX stack, no
OpenCV or PIL, and none of the JAX package (whose ``__init__`` imports JAX).
A subprocess refuses those imports, then imports every module of the port and
``chip_smoke``. ``chip_smoke.py`` must also fail, printing no result, where
there is no card or no repository around it.
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
    assert n >= 30          # lm/*, ops/*, decode/*, utils/posteriors included


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
