"""The mesh of ``bin_tpu/parallel`` over ``torch.distributed``.

``bin_tpu`` lays a ``jax.sharding.Mesh`` over its devices: the batch
sharded over ``data``, the parameters replicated, and optionally the
frames' height over ``spatial``.  Here both axes are ranks of a process
group, one card each (NCCL; gloo for ``--device cpu``): every rank holds
the whole model; the ranks of the data axis take their own rows of the
global batch (or their share of the eval clips or the streams), and the
gradients are averaged across ranks before the update; the ranks of a
spatial row each hold one band of every frame's height and exchange the
halo rows of every row-crossing conv (``spatial.py``).
"""

from bin_tpu_torch.parallel.distributed import (
    is_multi_host, maybe_initialize, process_batch_slice)
from bin_tpu_torch.parallel.mesh import MeshPlan, make_mesh

__all__ = ["MeshPlan", "make_mesh", "maybe_initialize", "is_multi_host",
           "process_batch_slice"]
