"""PyTorch/CUDA port of bin_tpu: joint video deblurring and 2x frame
interpolation on an NVIDIA H100.

The JAX package ``bin_tpu`` stays the reference.  This package imports
neither JAX nor ``bin_tpu``.  Its CUDA kernels (``csrc/``) replace the two
Pallas kernels of ``bin_tpu/ops/pallas`` and run the int8 serving mode's
quantize and conv.  Entry points run on CUDA unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.
"""

from bin_tpu_torch.config import ModelConfig, config3_prf
from bin_tpu_torch.registry import Model, build_model

__all__ = ["ModelConfig", "config3_prf", "Model", "build_model"]
