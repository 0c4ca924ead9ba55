"""Joining a process group (``bin_tpu/parallel/distributed.py``).

``maybe_initialize`` is called by every entry point: it joins the group
when the process was started by ``torchrun`` (``python -m
torch.distributed.run``, which sets ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) or when it is given an
address, and is a no-op otherwise.  On ``cuda`` the backend is NCCL and
each process takes the card ``cuda:LOCAL_RANK``; gloo serves only
``--device cpu``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize", "is_multi_host", "process_batch_slice",
           "world", "local_device", "shutdown"]

_LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def local_device(device: torch.device | str) -> torch.device:
    """``device`` as this process uses it: ``cuda`` becomes ``cuda:LOCAL_RANK``
    under a launcher (``cuda:0`` without one); other devices stay."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def maybe_initialize(device: torch.device | str = "cuda",
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> bool:
    """Join the process group; True when this process is in one.

    Without ``init_method`` it joins only under a launcher (the
    environment above, read by ``env://``); with it (e.g.
    ``tcp://localhost:29500``) ``world_size`` and ``rank`` are given by the
    caller.  A process already in a group stays in it.  ``cuda`` without a
    card raises: there is no retreat to gloo on a CUDA run."""
    if dist.is_initialized():
        return True
    launcher = all(v in os.environ for v in _LAUNCHER_ENV)
    if init_method is None and not launcher:
        return False
    device = local_device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for an NCCL process group; "
                               "pass --device cpu to train on the CPU "
                               "over gloo")
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {} if init_method is None else {"world_size": world_size,
                                         "rank": rank}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_multi_host() -> bool:
    return world()[1] > 1


def process_batch_slice(global_batch: int, rank: int | None = None,
                        world_size: int | None = None) -> tuple[int, int]:
    """(per-process batch, start offset) of an evenly split global batch;
    the rank and world size are the group's unless given."""
    r, n = world()
    rank = r if rank is None else rank
    n = n if world_size is None else world_size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return per, per * rank
