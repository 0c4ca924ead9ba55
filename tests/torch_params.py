"""Random parameters for bin_tpu and bin_tpu_torch alike, from a numpy seed;
and ``one_torch_thread``, a fixture for test modules of small shapes.

The tree is shaped from a port module's ``state_dict`` (flax names, kernels
(kh, kw, I, O)), which spares the tests flax's eager ``init``.  A name or
shape the JAX module does not expect fails its ``apply``; the release
weights test holds the mapping itself one to one.
"""

import numpy as np
import pytest
import torch


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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after.  At
    small shapes torch gains nothing from more, and the suite runs several
    worker processes at once, whose thread pools would otherwise spin
    against each other for the cores.  Import it into a test module to
    apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
