"""Model configuration of the PyTorch port.

A copy of the ``ModelConfig`` fields that inference reads, after
``bin_tpu/config.py``.  The port keeps its own copy instead of importing the
JAX package, so that it runs where JAX is not installed.  Fields that only
select between bit-exact layouts on the TPU (``s2d_via_conv``,
``d2s_via_conv``, ``d2s_final_via_conv``) or belong to training or the int8
path are not carried: a weights card that names them loads, and
``load_weights`` refuses a card that asks for int8 inference.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ModelConfig", "config3_prf"]


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the pyramid / recurrent model."""

    name: str = "prf"              # "backbone" | "pyramid" | "prf"
    num_levels: int = 2            # pyramid depth (levels beyond inputs)
    window_size: int = 4           # blurry key frames per sliding window
    base_features: int = 64        # channels at the stem resolution
    channel_mult: tuple[int, ...] = (1, 2, 4)  # per encoder scale
    stem_factor: int = 2           # space-to-depth factor at the stem
    num_res_blocks: int = 4        # residual blocks at the bottleneck
    lrelu_slope: float = 0.1
    convlstm_features: int = 256   # hidden channels of the ConvLSTM
    use_convlstm: bool = True      # recurrence between windows
    cycle_level: bool = True       # extra top level (centre frame again)
    clamp_intermediate: bool = True  # clip frames between levels to [-0.5, 1.5]
    dtype: str = "float32"         # compute dtype ("float32" | "bfloat16")


def config3_prf() -> ModelConfig:
    """The model part of ``bin_tpu``'s ``config3_prf`` preset, the
    architecture of the released weights."""
    return ModelConfig(name="prf", num_levels=2, use_convlstm=True,
                       cycle_level=True, base_features=128)

