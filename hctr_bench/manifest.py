"""Finding a cell's parts by name: ``BENCHMARK.json`` at the repository root
names the cells, configurations and metrics; each configuration, traffic
mix, cell's limits and per-layer metric is a file of its own here.

  * ``configs/<config>.json``: the deployment (the `configs` entry's
    ``file``);
  * ``traffic/<traffic>.json``: the traffic mix, read by ``traffic.py``;
  * ``limits/<cell>.json``: the limits of the numbers that decide
    ``correct``, each with the readings it was set from;
  * ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``
    returning a number or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Manifest:
    """``BENCHMARK.json``'s entries by name; ``folder`` holds the traffic
    and limits files."""

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


def reader(metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "hctr_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(metrics: List[dict]) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"]) for m in metrics}
