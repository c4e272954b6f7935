"""pytest settings of the benchmark's own tests (``test_hctr_bench_*.py``),
run from the repository root: ``python -m pytest hctr_bench``."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
