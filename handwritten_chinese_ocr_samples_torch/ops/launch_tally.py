"""Kernel launches made while a CUDA graph is captured.

The wrappers of K2-K4 count their kernel's launches in their module's
``launches``. A launch made while the calling thread captures a CUDA graph
is recorded into the graph, not made: inside ``tallying()`` the wrappers
tally it for the thread instead of counting it (``counted``), and whoever
replays the graph adds the tally to the counters at each replay. The tally
is the calling thread's own, so a data shard's capture takes in none of the
launches other threads make meanwhile.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_local = threading.local()


@contextmanager
def tallying():
    """Within the block, the calling thread's launches are tallied in the
    yielded dict (module name -> launches) and counted nowhere else."""
    saved = getattr(_local, "tally", None)
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = saved


def counted(module: str) -> bool:
    """Whether a launch of ``module``'s kernel by the calling thread counts
    in its module now; where not, it is tallied for the block that
    tallies."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        return True
    tally[module] = tally.get(module, 0) + 1
    return False
