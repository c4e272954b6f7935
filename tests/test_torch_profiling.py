"""The port's ``utils/profiling.py`` on the CPU: ``profile_trace`` writes a
non-empty Chrome trace that names the ops of the region, also when the
region raises."""

import json
import os

import torch

from handwritten_chinese_ocr_samples_torch.utils.profiling import (
    profile_trace)


def test_profile_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    x = torch.randn(64, 64)
    with profile_trace(str(log_dir)) as prof:
        y = torch.mm(x, x).relu()
    assert prof is not None and y.shape == (64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(log_dir / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names and "aten::relu" in names



def test_profile_trace_writes_when_the_region_raises(tmp_path):
    """A region that fails still leaves its trace, and the profiler
    stopped: a second trace starts."""
    log_dir = tmp_path / "trace"
    x = torch.randn(8, 8)
    try:
        with profile_trace(str(log_dir)):
            torch.mm(x, x)
            raise KeyboardInterrupt
    except KeyboardInterrupt:
        pass
    assert len(os.listdir(log_dir)) == 1
    with profile_trace(str(log_dir)):
        torch.mm(x, x)
    assert len(os.listdir(log_dir)) == 2
