"""PyTorch/CUDA port of bin_tpu: joint video deblurring and 2x frame
interpolation on an NVIDIA H100.

The JAX package ``bin_tpu`` stays the reference.  This package imports
neither JAX nor ``bin_tpu``.  Its CUDA kernels (``csrc/``) replace the two
Pallas kernels of ``bin_tpu/ops/pallas`` and run the int8 serving mode's
quantize and conv.  Entry points run on CUDA unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.  The names
below are imported on first use, so that the data modules (and the
loader's worker processes) load without torch.
"""

__all__ = ["ModelConfig", "config3_prf", "Model", "build_model"]


def __getattr__(name: str):
    if name in ("ModelConfig", "config3_prf"):
        from bin_tpu_torch import config
        return getattr(config, name)
    if name in ("Model", "build_model"):
        from bin_tpu_torch import registry
        return getattr(registry, name)
    raise AttributeError(name)
