"""What the benchmark reads from the repository, with its own code: the
packed weights (``torch.save`` + ``lzma``, in parts listed with their
sha256 in a manifest), the test and tuning line images, their labels, the
recognizer's character list and the LM's dictionary; and weights drawn
from a seed where a configuration has no file of them (``seeded_state``).

A packed artifact is unpacked once a checkout: the state dict is written as
a plain ``torch.save`` file under ``CACHE``, keyed by the parts' sha256,
and later runs load that file.
"""

from __future__ import annotations

import hashlib
import json
import lzma
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
# artifact -> seconds spent unpacking it into CACHE in this process
unpacked: Dict[str, float] = {}


def repo_path(rel: str) -> str:
    return os.path.join(ROOT, rel)


def _unpack(path: str) -> bytes:
    """The ``torch.save`` bytes of a packed artifact, each part checked
    against the manifest's length and sha256."""
    with open(path + ".json", encoding="utf-8") as f:
        manifest = json.load(f)
    folder = os.path.dirname(path)
    chunks = []
    for part in manifest["parts"]:
        with open(os.path.join(folder, part["name"]), "rb") as f:
            chunk = f.read()
        if (len(chunk) != part["bytes"]
                or hashlib.sha256(chunk).hexdigest() != part["sha256"]):
            raise ValueError(f"{part['name']} does not match its manifest")
        chunks.append(chunk)
    raw = lzma.decompress(b"".join(chunks))
    if len(raw) != manifest["raw_bytes"]:
        raise ValueError(f"{path}: {len(raw)} bytes unpacked, the manifest "
                         f"says {manifest['raw_bytes']}")
    return raw


def load_state(rel: str) -> Dict[str, torch.Tensor]:
    """A state dict in f32 on the host. ``rel`` names a plain ``torch.save``
    file, or a packed one (``<rel>.json`` is its manifest), which is
    unpacked into ``CACHE`` on first use."""
    path = repo_path(rel)
    if os.path.isfile(path + ".json"):
        with open(path + ".json", encoding="utf-8") as f:
            key = hashlib.sha256(f.read().encode()).hexdigest()[:16]
        cached = os.path.join(CACHE, f"{os.path.basename(rel)}.{key}.pt")
        if not os.path.isfile(cached):
            t0 = time.perf_counter()
            os.makedirs(CACHE, exist_ok=True)
            raw = _unpack(path)
            with open(cached + ".part", "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())     # written now, not in the window
            os.replace(cached + ".part", cached)
            unpacked[rel] = time.perf_counter() - t0
        path = cached
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.float() if v.is_floating_point() else v)
            for k, v in state.items()}


def seeded_state(specs: Dict[str, tuple], seed: int, device,
                 dtype: torch.dtype = torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """A state dict drawn from ``seed`` on ``device``: ``specs`` maps each
    name to ``(shape, init)``, where ``init`` is a normal's standard
    deviation, ``"ones"`` or ``"zeros"``. Each tensor's generator is seeded
    from ``seed`` and the sha256 of its name, so that its values depend on
    neither the other names nor their order."""
    device = torch.device(device)
    out = {}
    for name, (shape, init) in specs.items():
        shape = tuple(int(s) for s in shape)
        if init == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif isinstance(init, (int, float)) and not isinstance(init, bool):
            digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
            g = torch.Generator(device=device)
            g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
            t = torch.randn(shape, generator=g, device=device, dtype=dtype)
            out[name] = t.mul_(float(init))
        else:
            raise ValueError(f"{name}: init {init!r} is not a standard "
                             f"deviation, 'ones' or 'zeros'")
    return out


def read_gray(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def read_lines(folder: str, names: List[str] | None = None
               ) -> Tuple[List[str], List[np.ndarray]]:
    """``(names, (h, w) uint8 images)`` of a folder's line images, by
    sorted name unless ``names`` are given."""
    path = repo_path(folder)
    if names is None:
        names = sorted(n for n in os.listdir(path) if n.endswith(".png"))
    return names, [read_gray(os.path.join(path, n)) for n in names]


def read_labels(rel: str) -> Dict[str, str]:
    """``name,text`` rows of a label file."""
    with open(repo_path(rel), encoding="utf-8") as f:
        return dict(line.rstrip("\n").split(",", 1) for line in f
                    if line.strip())


def read_chars(rel: str) -> List[str]:
    """The recognizer's characters: the file's lines joined, one class a
    character; class ``i + 1`` is character ``i`` (0 is the blank, the
    last class the unknown)."""
    with open(repo_path(rel), encoding="utf-8") as f:
        return list("".join(line.strip("\n") for line in f))


def read_lm_dict(rel: str) -> List[str]:
    """The LM's symbols: the four specials ``<s> <pad> </s> <unk>``, then
    the dictionary's entries (``symbol count`` a line) in order."""
    symbols = ["<s>", "<pad>", "</s>", "<unk>"]
    with open(repo_path(rel), encoding="utf-8") as f:
        for raw in f:
            if raw.strip():
                symbols.append(raw.rstrip().rsplit(" ", 1)[0])
    return symbols
