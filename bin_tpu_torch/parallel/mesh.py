"""The mesh as a plan (``bin_tpu/parallel/mesh.py``).

``bin_tpu``'s ``MeshPlan`` is a ``jax.sharding.Mesh`` of ``data`` x
``spatial`` devices, ``devices.reshape(data, spatial)``.  Here the devices
are the ranks of the process group, each with its card, laid out the same
way: rank r has data index r // spatial and spatial index r % spatial.
The ranks of one data index (a spatial row) share its streams or clips and
hold one band of the frames' height each (``parallel/spatial.py``), in a
process group of their own.  The plan also carries the collectives the
trainer and the evaluator use, over the data axis: the mean of a tensor,
the gather of per-clip results, and a barrier around rank 0's writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

import torch
import torch.distributed as dist

from bin_tpu_torch.config import ParallelConfig
from bin_tpu_torch.parallel.distributed import world

__all__ = ["MeshPlan", "make_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """``num_data`` x ``num_spatial`` ranks, of which this process is
    ``rank``, each on its own device.  ``group``: the ranks form a process
    group, whose collectives the plan runs even at one rank (a one-rank
    ``torchrun`` takes the path of many); without one they are no-ops.
    ``spatial_group``: the process group of this rank's spatial row, where
    ``num_spatial > 1``."""

    num_data: int = 1
    num_spatial: int = 1
    rank: int = 0
    group: bool = False
    spatial_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.num_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.num_spatial

    @property
    def is_main(self) -> bool:
        """The rank that writes checkpoints, logs and weights."""
        return self.rank == 0

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced in place by its mean over the data axis; every
        rank gets the same values (one all-reduce over all ranks: the ranks
        of one spatial row hold the same values, so the mean over all is
        the mean over the data axis)."""
        if self.group:
            dist.all_reduce(t)
            t.mul_(1.0 / (self.num_data * self.num_spatial))
        return t

    def gather(self, obj: Any) -> list:
        """Every data index's ``obj``, in data order (pickled; the first
        rank of each spatial row speaks for it)."""
        if not self.group:
            return [obj]
        out: list = [None] * (self.num_data * self.num_spatial)
        dist.all_gather_object(out, obj)
        return out[::self.num_spatial]

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
    """The plan of ``cfg`` in this process group: ``spatial_axis_size``
    ranks to a spatial row, ``data_axis_size`` rows (-1: as many as the
    world holds, 1 without a launcher); data x spatial must be the world
    size.  With a spatial axis every rank forms the groups of all the
    spatial rows, in order, and keeps its own."""
    cfg = cfg or ParallelConfig()
    spatial = max(1, cfg.spatial_axis_size)
    rank, n = world()
    data = n // spatial if cfg.data_axis_size == -1 else cfg.data_axis_size
    if data * spatial != n or data < 1:
        raise ValueError(
            f"parallel.data_axis_size={cfg.data_axis_size} x "
            f"spatial_axis_size={spatial}: the mesh is the ranks of the "
            f"process group, and this run has {n}; start "
            f"{max(data, 1) * spatial} processes with torchrun (python -m "
            f"torch.distributed.run --nproc_per_node="
            f"{max(data, 1) * spatial} ...), or set data_axis_size=-1 for "
            "all of them")
    group = dist.is_initialized()
    mine = None
    if group and spatial > 1:
        for d in range(data):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == rank // spatial:
                mine = g
    return MeshPlan(num_data=data, num_spatial=spatial, rank=rank,
                    group=group, spatial_group=mine)
