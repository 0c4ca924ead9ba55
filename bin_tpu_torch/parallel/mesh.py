"""The data axis as a plan (``bin_tpu/parallel/mesh.py``).

``bin_tpu``'s ``MeshPlan`` is a ``jax.sharding.Mesh`` of ``data`` x
``spatial`` devices; here ``num_data`` is the number of ranks of the process
group, each with its card, and ``num_spatial`` is always 1.  The plan also
carries the collectives the trainer and the evaluator use: the mean of a
tensor across ranks, the gather of per-clip results, and a barrier around
rank 0's writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

import torch
import torch.distributed as dist

from bin_tpu_torch.config import ParallelConfig
from bin_tpu_torch.parallel.distributed import world

__all__ = ["MeshPlan", "make_mesh", "SPATIAL_NOT_PORTED"]

SPATIAL_NOT_PORTED = (
    "spatial (height) sharding is not ported to bin_tpu_torch: it needs a "
    "halo exchange in every conv of the pyramid, the next slice of "
    "ROADMAP.md queue 1 (with StreamingSession(plan=) and "
    "bin-tpu-serve --spatial)")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """``num_data`` ranks, of which this process is ``rank``, each on its
    own device; ``num_spatial`` is 1.  ``group``: the ranks form a process
    group, whose collectives the plan runs even at one rank (a one-rank
    ``torchrun`` takes the path of many); without one they are no-ops."""

    num_data: int = 1
    num_spatial: int = 1
    rank: int = 0
    group: bool = False

    @property
    def is_main(self) -> bool:
        """The rank that writes checkpoints, logs and weights."""
        return self.rank == 0

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced in place by its mean over the ranks; every rank
        gets the same values (one all-reduce)."""
        if self.group:
            dist.all_reduce(t)
            t.mul_(1.0 / self.num_data)
        return t

    def gather(self, obj: Any) -> list:
        """Every rank's ``obj``, in rank order (pickled)."""
        if not self.group:
            return [obj]
        out: list = [None] * self.num_data
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.group:
            dist.barrier()

    @contextlib.contextmanager
    def main_writes(self) -> Iterator[bool]:
        """A block that rank 0 runs (it yields True there) between two
        barriers: no rank reads what rank 0 writes before it is whole."""
        self.barrier()
        try:
            yield self.is_main
        finally:
            self.barrier()


def make_mesh(cfg: ParallelConfig | None = None) -> MeshPlan:
    """The plan of ``cfg`` in this process group.  ``data_axis_size=-1``
    is the world size (1 without a launcher); any other size must be the
    world size.  ``spatial_axis_size > 1`` raises: not ported."""
    cfg = cfg or ParallelConfig()
    if cfg.spatial_axis_size > 1:
        raise ValueError(f"parallel.spatial_axis_size="
                         f"{cfg.spatial_axis_size}: {SPATIAL_NOT_PORTED}")
    rank, n = world()
    data = n if cfg.data_axis_size == -1 else cfg.data_axis_size
    if data != n:
        raise ValueError(
            f"parallel.data_axis_size={cfg.data_axis_size}: the data axis is "
            f"the ranks of the process group, and this run has {n}; start "
            f"{data} processes with torchrun (python -m torch.distributed.run"
            f" --nproc_per_node={data} ...), or set -1 for all of them")
    return MeshPlan(num_data=n, rank=rank, group=dist.is_initialized())
