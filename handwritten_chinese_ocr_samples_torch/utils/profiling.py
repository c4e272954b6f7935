"""Profiling (the JAX package's ``utils/profiling.py``).

``profile_trace`` wraps a region in ``torch.profiler`` with the CPU and, on
a machine with a card, the CUDA activities, and writes a Chrome trace into
``log_dir`` (``<host>_<pid>.<ns>.pt.trace.json``, as
``torch.profiler.tensorboard_trace_handler`` names it: TensorBoard's
profiler plugin and Perfetto read it). The JAX module's ``StepTimer`` is
not copied: only a test of the JAX package calls it, and no path of the
port times steps on the host.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """``torch.profiler`` over the enclosed region; on exit the card's
    queued work is waited for and the trace is written into ``log_dir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()

