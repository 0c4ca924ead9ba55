"""Height (spatial) sharding: bands, halos, and how the rows travel.

``bin_tpu`` shards frame height over the ``spatial`` mesh axis and lets
XLA insert the halo exchanges (``bin_tpu/parallel/mesh.py`` ``MeshPlan.
activation``).  Here each rank of a spatial group holds one band of rows
and every op that reads rows outside its band asks for them by hand:

- a 3x3 stride-1 SAME conv reads 1 row on each side, zeros at the frame's
  edges; the stride-2 ``Downsample`` (SAME on an even height pads (0, 1))
  reads 0 rows above and 1 below; the int8 convs as the float ones, after
  the quantize, so the rows travel as int8;
- ``Upsample``'s phase-bank conv reads 1 low-resolution row on each side
  and repeats the frame's edge row there (a replicate pad, never zeros).

After the exchange each conv runs VALID in height and SAME in width.
Everything else on the path (K2's pack, depth-to-space, K1, the 1x1
context projection, the pair mean, the clamps) is row-local.

Bands (``packed_bands``) are whole blocks of ``block_rows`` packed rows,
dealt as evenly as they go, the first bands taking one more: every level
of the backbone then has whole bands, and each stride-2 conv an even band.

Which rows a band needs is pure (``with_halo``, given the neighbours'
rows); how they arrive is ``HaloExchange``: point-to-point sends between
neighbours in the process group of the rank's spatial row, on the device
for NCCL, through host tensors for gloo (the CPU, and ranks that share one
card).  The backend is the caller's group's; nothing switches on failure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["block_rows", "packed_bands", "height_bands", "halo_rows",
           "with_halo", "Halo", "HaloExchange", "gather_world"]


def block_rows(channel_mult) -> int:
    """Packed rows of one block: the rows of one bottleneck row at the
    stem's resolution, 2^(levels - 1)."""
    return 2 ** (len(channel_mult) - 1)


def packed_bands(packed_height: int, num_spatial: int,
                 block: int) -> list[tuple[int, int]]:
    """(first row, rows) of each of ``num_spatial`` bands of a packed
    height.  Raises, naming the spatial axis, where ``bin_tpu`` refuses
    the height (it does not divide over the axis) and where it cannot be
    cut into whole blocks, at least one a band."""
    if packed_height % num_spatial:
        raise ValueError(f"packed height {packed_height} must divide over "
                         f"spatial={num_spatial} mesh axis")
    if packed_height % block or packed_height // block < num_spatial:
        raise ValueError(
            f"packed height {packed_height} cannot be cut into spatial="
            f"{num_spatial} bands of whole blocks of {block} rows (one "
            "bottleneck row each): pick a height that is a multiple of "
            f"{block} packed rows, at least {block * num_spatial}")
    base, extra = divmod(packed_height // block, num_spatial)
    out, start = [], 0
    for k in range(num_spatial):
        rows = (base + (k < extra)) * block
        out.append((start, rows))
        start += rows
    return out


def height_bands(stem_factor: int, channel_mult, height: int,
                 num_spatial: int) -> list[tuple[int, int]]:
    """(first row, rows) of each band of a frame ``height`` rows high, in
    the frame's own rows: a band starts on a multiple of the stem."""
    return [(s * stem_factor, n * stem_factor) for s, n in packed_bands(
        height // stem_factor, num_spatial, block_rows(channel_mult))]


def halo_rows(stride: int) -> tuple[int, int]:
    """(rows above, rows below) a band of a 3x3 SAME conv reads: 1 and 1,
    or for stride 2 on an even height, SAME's (0, 1)."""
    return (1, 1) if stride == 1 else (0, 1)


def with_halo(x: torch.Tensor, above: torch.Tensor | None,
              below: torch.Tensor | None, up: int, down: int,
              replicate: bool = False) -> torch.Tensor:
    """The band ``x`` (B, rows, W, C) with ``up`` rows over it and ``down``
    under it: the neighbours' rows, or at the frame's edge (None) zeros,
    or with ``replicate`` the band's edge row repeated."""
    parts = []
    if up:
        if above is None:
            above = (x[:, :1].expand(-1, up, -1, -1) if replicate else
                     x.new_zeros((x.shape[0], up, *x.shape[2:])))
        parts.append(above)
    parts.append(x)
    if down:
        if below is None:
            below = (x[:, -1:].expand(-1, down, -1, -1) if replicate else
                     x.new_zeros((x.shape[0], down, *x.shape[2:])))
        parts.append(below)
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


class Halo:
    """What a row-crossing op asks of its band's neighbours.  ``exchange``
    returns (the ``up`` rows above the band, the ``down`` rows below it),
    None at the frame's edge; ``amax`` is the maximum of a one-value
    tensor over the bands (the dynamic int8 scale).  Subclasses say how
    the rows arrive; the tests hand them in."""

    exchanges = 0      # calls of halo()
    bytes_sent = 0     # of the rows this band sent its neighbours

    def exchange(self, x: torch.Tensor, up: int, down: int):
        raise NotImplementedError

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def halo(self, x: torch.Tensor, up: int, down: int,
             replicate: bool = False) -> torch.Tensor:
        """``x`` with its halo rows (``with_halo``)."""
        above, below = self.exchange(x, up, down)
        self.exchanges += 1
        return with_halo(x, above, below, up, down, replicate)

    def reset_counts(self) -> None:
        self.exchanges = self.bytes_sent = 0


class HaloExchange(Halo):
    """The halo rows of this rank's band from the neighbouring ranks of
    its spatial row (``MeshPlan.spatial_group``): the rank above sends its
    last rows, the rank below its first, in one batch of point-to-point
    sends and receives.  With a gloo group the rows go through host
    tensors and come back to ``x``'s device."""

    def __init__(self, plan):
        self.group = plan.spatial_group
        self.count = plan.num_spatial
        index = plan.spatial_index
        self.prev = plan.rank - 1 if index > 0 else None
        self.next = plan.rank + 1 if index < self.count - 1 else None
        self.host = dist.get_backend(self.group) == "gloo"

    def exchange(self, x: torch.Tensor, up: int, down: int):
        where = "cpu" if self.host else x.device
        ops, got = [], {}
        # the rank above needs our first `down` rows and sends us its last
        # `up`; the rank below the other way round
        for peer, send, recv in ((self.prev, x[:, :down], up),
                                 (self.next, x[:, x.shape[1] - up:], down)):
            if peer is None:
                continue
            if send.shape[1]:
                t = send.contiguous().to(where)
                self.bytes_sent += t.numel() * t.element_size()
                ops.append(dist.P2POp(dist.isend, t, peer, self.group))
            if recv:
                got[peer] = torch.empty((x.shape[0], recv, *x.shape[2:]),
                                        dtype=x.dtype, device=where)
                ops.append(dist.P2POp(dist.irecv, got[peer], peer,
                                      self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tuple(None if t is None else t.to(x.device)
                     for t in (got.get(self.prev), got.get(self.next)))

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        v = t.detach().float().reshape(()).clone()
        if self.host:
            v = v.cpu()
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        return v.to(t.device)

    def gather_rows(self, x: torch.Tensor, sizes: list[int],
                    dim: int) -> torch.Tensor:
        """The whole frames from every band of the spatial row: ``x`` is
        this band, ``sizes`` every band's rows along ``dim``.  Every rank
        gets them, on ``x``'s device."""
        return _gather(x, sizes, dim, self.group, self.count, self.host,
                       lambda parts: torch.cat(parts, dim))


def _gather(x: torch.Tensor, sizes: list[int], dim: int, group, n: int,
            host: bool, join) -> torch.Tensor:
    """all_gather over ``group`` (``n`` ranks) of bands of ``sizes`` rows
    along ``dim``, padded to the tallest for the collective; ``join``
    makes one tensor of the n trimmed parts, in rank order."""
    tallest = max(sizes)
    t = x
    if t.shape[dim] < tallest:
        pad = [0, 0] * (t.dim() - dim - 1) + [0, tallest - t.shape[dim]]
        t = F.pad(t, pad)
    t = (t.cpu() if host else t).contiguous()
    bufs = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(bufs, t, group=group)
    parts = [b.narrow(dim, 0, sizes[i % len(sizes)])
             for i, b in enumerate(bufs)]
    return join(parts).to(x.device)


def gather_world(plan, x: torch.Tensor, sizes: list[int], row_dim: int,
                 batch_dim: int) -> torch.Tensor:
    """Whole frames of the whole batch from every rank: ``x`` is this
    rank's streams (its data index's share of ``batch_dim``) and band
    (``sizes``: every band's rows along ``row_dim``).  Every rank gets the
    result, on ``x``'s device."""
    s = plan.num_spatial

    def join(parts):
        rows = [torch.cat(parts[d * s:(d + 1) * s], row_dim)
                for d in range(plan.num_data)]
        return torch.cat(rows, batch_dim)

    if not plan.group:
        return x
    host = dist.get_backend() == "gloo"
    return _gather(x, sizes, row_dim, None, plan.num_data * s, host, join)
