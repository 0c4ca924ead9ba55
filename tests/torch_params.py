"""Random parameters for bin_tpu and bin_tpu_torch alike, from a numpy seed.

The tree is shaped from a port module's ``state_dict`` (flax names, kernels
(kh, kw, I, O)), which spares the tests flax's eager ``init``.  A name or
shape the JAX module does not expect fails its ``apply``; the release
weights test holds the mapping itself one to one.
"""

import numpy as np


def random_flax_params(module, seed: int = 7, scale: float = 0.05) -> dict:
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for key, value in sorted(module.state_dict().items()):
        *mods, leaf = key.split(".")
        shape = tuple(value.shape)
        if leaf == "weight":
            leaf, shape = "kernel", (shape[2], shape[3], shape[1], shape[0])
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = rng.normal(0, scale, shape).astype(np.float32)
    return tree
