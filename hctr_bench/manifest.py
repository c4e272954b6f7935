"""Finding a cell's parts by name: ``BENCHMARK.json`` at the repository root
names the cells, configurations and metrics; each configuration, traffic
mix, cell's limits and per-layer metric is a file of its own here.

  * ``configs/<config>.json``: the deployment (the `configs` entry's
    ``file``);
  * ``traffic/<traffic>.json``: the traffic mix, read by ``traffic.py``;
  * ``limits/<cell>.json``: the limits of the numbers that decide
    ``correct``, each with the readings it was set from;
  * ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``
    returning a number or None where it finds nothing to read. It may
    declare ``COUNTERS = {"<name>": "<module>:<attribute>"}``, counters of
    the port whose change over the traced run's first window it reads
    (``ctx.counter(name)``), and ``SPANS = True``, to have the port's spans
    kept through that window (``ctx.spans``);
  * ``lms/<arch>.py``: the plug-in of a configuration's fusion LM (its
    ``lm`` block's ``arch``, ``char-transformer`` where it names none),
    with ``load_state``, ``program_lm``, ``reference_lm``, ``token_flops``
    and optionally ``bounds`` and ``program_logprobs`` (the program side
    of the check's ``lm_gap``).
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, Iterable, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_LM = "char-transformer"
LM_FUNCTIONS = ("load_state", "program_lm", "reference_lm", "token_flops")


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json``'s entries by name; ``folder`` holds the traffic,
    limits, metric and LM plug-in files (the last two, where it lacks
    them, are the benchmark's own)."""

    def __init__(self, data: dict, folder: str = HERE):
        self.data = data
        self.folder = folder
        self.cells = {w["name"]: w for w in data["workloads"]}
        self.configs = {c["name"]: c for c in data["configs"]}

    @classmethod
    def load(cls, path: str = os.path.join(ROOT, "BENCHMARK.json")):
        return cls(_json(path))

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(there are {sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        return _json(os.path.join(ROOT, self.configs[name]["file"]))

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.folder, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return _json(os.path.join(self.folder, "limits", f"{cell}.json"))

    def _applies(self, metric: dict, cell: str) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return True

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]

    def _code(self, sub: str, name: str) -> str:
        """``<sub>/<name>.py`` in ``folder``, or else the benchmark's own."""
        path = os.path.join(self.folder, sub, f"{name}.py")
        return path if os.path.isfile(path) else os.path.join(
            HERE, sub, f"{name}.py")

    def metrics(self, metrics: List[dict]) -> Dict[str, ModuleType]:
        """``name -> metrics/<name>.py`` of each of ``metrics``."""
        return {m["name"]: _load(self._code("metrics", m["name"]),
                                 "hctr_bench_metric_" + m["name"])
                for m in metrics}

    def lm(self, lm_cfg: dict) -> ModuleType:
        """The plug-in ``lms/<arch>.py`` of a configuration's ``lm``
        block."""
        arch = lm_cfg.get("arch", DEFAULT_LM)
        module = _load(self._code("lms", arch), "hctr_bench_lm_" + arch)
        missing = [f for f in LM_FUNCTIONS
                   if not callable(getattr(module, f, None))]
        if missing:
            raise AttributeError(f"lms/{arch}.py lacks {missing}")
        if not hasattr(module, "bounds"):
            module.bounds = {}
        return module


def _load(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _load(os.path.join(HERE, "metrics", f"{metric}.py"),
                 "hctr_bench_metric_" + metric).read


def declared(modules: Iterable[ModuleType]) -> Tuple[Dict[str, str], bool]:
    """What metric modules ask the traced run's first window for: the
    port's counters (``COUNTERS``, merged by name) and whether to keep the
    port's spans (any ``SPANS``)."""
    counters: Dict[str, str] = {}
    spans = False
    for module in modules:
        for name, path in getattr(module, "COUNTERS", {}).items():
            if counters.setdefault(name, path) != path:
                raise ValueError(f"counter {name!r} is declared as both "
                                 f"{counters[name]!r} and {path!r}")
        spans = spans or bool(getattr(module, "SPANS", False))
    return counters, spans
