"""The data axis of ``bin_tpu/parallel`` over ``torch.distributed``.

``bin_tpu`` lays a ``jax.sharding.Mesh`` over its devices: the batch
sharded over ``data``, the parameters replicated, and optionally the
frames' height over ``spatial``.  Here the data axis is the ranks of a
process group, one card each (NCCL; gloo for ``--device cpu``): every rank
holds the whole model, takes its own rows of the global batch (or its share
of the eval clips), and the gradients are averaged across ranks before the
update.  Spatial sharding is not ported: it needs a halo exchange in every
conv.
"""

from bin_tpu_torch.parallel.distributed import (
    is_multi_host, maybe_initialize, process_batch_slice)
from bin_tpu_torch.parallel.mesh import MeshPlan, make_mesh

__all__ = ["MeshPlan", "make_mesh", "maybe_initialize", "is_multi_host",
           "process_batch_slice"]
