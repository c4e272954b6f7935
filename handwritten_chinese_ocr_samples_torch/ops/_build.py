"""Build the port's CUDA sources into shared libraries and load them.

``nvcc`` compiles each ``csrc/<name>.cu`` into its own plain shared library
with a C interface, loaded with ``ctypes``. No PyTorch header is included, so
a build takes seconds (one that includes them takes minutes), and no
``ninja`` is needed. The libraries land in ``build/torch_kernels/`` at the
repository root, named by a hash of the source and the flags, so an unchanged
source never rebuilds. ``build_all`` starts one ``nvcc`` per missing library,
all at once; ``load`` builds what it needs at first use, never at import.

The host libraries of ``native/<name>.cc`` (the CTC beam search with its
n-gram scorer, and the edit distance) are built the same way with the host
C++ compiler (``c++`` or ``g++`` on ``PATH``, which ``nvcc`` needs anyway)
by ``load_host``. A build that fails raises: no caller falls back to a
Python version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
NATIVE = _PKG / "native"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O3", "-std=c++17", "-Wall", "-Wextra", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}
# How each library was obtained: name -> {"seconds": nvcc wall time,
# "cached": bool}; a host library's entry also has its "path".
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(/usr/local/cuda); the CUDA kernels cannot be built")


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH; the "
                       "native libraries under native/ cannot be built")


def _library_path(src: Path, flags=NVCC_FLAGS) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _build_missing(names) -> None:
    """Compile the libraries of ``names`` that are not built yet, one
    ``nvcc`` process each, all running together. Caller holds ``_lock``."""
    started = []
    for name in names:
        src = CSRC / f"{name}.cu"
        out = _library_path(src)
        if out.is_file():
            build_info.setdefault(name, {"seconds": 0.0, "cached": True})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started.append((name, cmd, proc, tmp, out, time.perf_counter()))
    failures = []
    for name, cmd, proc, tmp, out, t0 in started:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n"
                            f"{' '.join(cmd)}\n{err}")
            continue
        os.replace(tmp, out)
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "cached": False}
    if failures:
        raise RuntimeError("\n".join(failures))


def build_all() -> dict:
    """Build every ``csrc/*.cu`` that is not built yet, in parallel;
    returns ``build_info``."""
    with _lock:
        _build_missing(sorted(p.stem for p in CSRC.glob("*.cu")))
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing.
    The caller declares its functions' ``argtypes`` and ``restype``."""
    with _lock:
        if name not in _libs:
            _build_missing([name])
            _libs[name] = ctypes.CDLL(str(_library_path(CSRC / f"{name}.cu")))
        return _libs[name]


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``native/<name>.cc``, compiled with the
    host C++ compiler first if missing (keyed by a hash of the source and
    the flags). Raises if the compiler is missing or fails."""
    key = f"host:{name}"
    with _lock:
        if key not in _libs:
            src = NATIVE / f"{name}.cc"
            out = _library_path(src, HOST_FLAGS)
            info = {"seconds": 0.0, "cached": True, "path": str(out)}
            if not out.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_cxx(), *HOST_FLAGS, "-o", str(tmp), str(src)]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"host build failed ({proc.returncode})"
                                       f":\n{' '.join(cmd)}\n{proc.stderr}")
                os.replace(tmp, out)
                info.update(seconds=time.perf_counter() - t0, cached=False)
            _libs[key] = ctypes.CDLL(str(out))
            build_info[key] = info
        return _libs[key]
