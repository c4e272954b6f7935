"""Process groups, data devices and row shards (the JAX package's
``parallel/mesh.py``).

The JAX package drives every local chip from one process through a
``(data, model)`` mesh and lets XLA place the collectives. The port keeps
the reference's idiom (`main.py:157-237`): one process per card, started by
``python -m torch.distributed.run``, with explicit collectives:

  * training: every rank takes its ``B / W`` rows of each global batch;
    ``all_reduce_mean`` averages the flat gradient list and the loss before
    the update, and train-mode BatchNorm reduces its statistics over the
    group (``models/hctr.py``), so a step over ``W`` ranks is the
    one-process step on the whole batch;
  * eval ``-dp N``: one process, ``N`` row shards of each batch on
    ``data_devices(N)``, each with its own weight replica and host thread.

Not ported: ``width_sharding`` (no path of the JAX package reaches it) and
a ``model`` axis above 1 (``param_shardings``/``shard_train_state``): the
JAX trainer always builds ``model=1``, so every parameter is replicated, as
here.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def initialize_distributed(device: str = "cuda",
                           init_method: Optional[str] = None
                           ) -> torch.device:
    """Join the process group of a ``torch.distributed.run`` launch (its
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/
    ``MASTER_PORT``; or ``init_method``, e.g. ``file://...``, with ``RANK``
    and ``WORLD_SIZE``) over NCCL for ``device == "cuda"``, else gloo, and
    return this rank's device (``cuda:LOCAL_RANK`` or the CPU). Without a
    launcher's environment it starts nothing and returns ``device``."""
    kind = torch.device(device).type
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local) if kind == "cuda" else torch.device(
        device)
    if dist.is_initialized():
        return dev
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return torch.device(device)
    if kind == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend="nccl" if kind == "cuda" else "gloo",
        init_method=init_method or "env://",
        rank=int(os.environ.get("RANK", "0")),
        world_size=int(os.environ.get("WORLD_SIZE", "1")))
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, or no group: the process that prints and writes files."""
    return rank() == 0


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the group (a no-op without one)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def all_reduce_mean(loss: torch.Tensor, grads: Sequence[torch.Tensor]):
    """``(loss, grads)`` averaged over the group in one collective on a flat
    buffer; returned as they are without a group. The mean of the ranks'
    batch-mean losses (and of their gradients) is the whole batch's, since
    every rank holds as many rows. The averages are copied back into the
    gradient tensors given: views into the buffer would be laid out
    otherwise, and the foreach kernels that read them next (the clip's
    norm) sum in another order at another alignment."""
    grads = list(grads)
    if not dist.is_initialized():
        return loss, grads
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat)
    flat /= world_size()
    parts = torch.split(flat[:-1], [g.numel() for g in grads])
    torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(parts, grads)])
    return flat[-1].to(loss.dtype), grads


def data_devices(n: int, device: str = "cuda") -> List[torch.device]:
    """The devices of ``n`` data shards: the first ``n`` cards, or ``n``
    CPU shards for ``device == "cpu"`` (the JAX tests' virtual devices)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * n
    n_dev = torch.cuda.device_count()
    if n > n_dev:
        raise ValueError(f"--data-parallel {n} exceeds the {n_dev} visible "
                         f"devices")
    return [torch.device(kind, i) for i in range(n)]


def canonical(device) -> torch.device:
    """``device`` with its index (``cuda`` -> ``cuda:<current>``), so that
    two names of one device compare equal."""
    return torch.empty(0, device=device).device


def shard_rows(x, n: int, i: int):
    """Rows ``[i * B / n, (i + 1) * B / n)`` of a batch-leading tensor or
    array; a batch that ``n`` does not divide raises."""
    B = x.shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by {n} shards")
    s = B // n
    return x[i * s: (i + 1) * s]


_local = threading.local()


@contextlib.contextmanager
def on_shard(index: int, device: torch.device):
    """Work of data shard ``index`` on this thread: its CUDA device made
    current (kernel launches go to the current device; nothing for the
    CPU), and ``current_shard()`` reporting ``index`` meanwhile."""
    prev = getattr(_local, "shard", None)
    _local.shard = index
    try:
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            yield
    finally:
        _local.shard = prev


def current_shard() -> Optional[int]:
    """The data shard this thread works for (None outside ``on_shard``)."""
    return getattr(_local, "shard", None)
