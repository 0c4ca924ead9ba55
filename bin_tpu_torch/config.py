"""Configuration of the PyTorch port.

A copy of the ``ModelConfig`` fields that inference reads, after
``bin_tpu/config.py``, with ``apply_model_overrides`` for deployment knobs
layered over a weights card; and of the ``DataConfig`` fields that
evaluation reads, whose defaults are the release card's pinned protocol.
The port keeps its own copy instead of importing the JAX package, so that
it runs where JAX is not installed.
Fields that only select between bit-exact layouts on the TPU
(``s2d_via_conv``, ``d2s_via_conv``, ``d2s_final_via_conv``) or belong to
training (``conv_int8_qat``, ``conv_int8_calibrate``) or to an int8 option
no serving mode uses (``conv_int8_mse_clip``) are not carried: a weights
card that names them loads without them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

__all__ = ["ModelConfig", "DataConfig", "Config", "config3_prf",
           "apply_model_overrides", "apply_overrides"]


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
    conv_int8: bool = False        # int8 PTQ 3x3 convs (ops/quant.py)
    conv_int8_min_cin: int = 0     # ... only where Cin >= this
    conv_int8_lstm: bool = False   # ... and the ConvLSTM gate conv
    conv_int8_static: str = ""     # static activation scales (.npz);
                                   # "" = dynamic per-tensor abs-max


@dataclass(frozen=True)
class DataConfig:
    """The eval protocol (``bin_tpu/config.py`` ``DataConfig``, the fields
    evaluation reads).  The defaults are the protocol under which the
    release card's quality was measured (``weights/prf_ema_r4.card.json``
    ``eval_protocol``), so numbers are comparable across runs."""

    eval_size: tuple[int, int] = (256, 256)  # eval resolution (H, W)
    eval_num_clips: int = 16       # clips per eval pass
    eval_num_keys: int = 12        # blurry keys per eval clip; 0 = whole
                                   # clips (folder datasets only)
    eval_seed: int = 9999          # synthetic eval stream seed
    blur_taps: int = 11            # sharp frames averaged into one blurry frame
    blur_stride: int = 8           # stride between blurry frames
    synthetic_style: str = "textured"  # "textured" | "smooth"


@dataclass(frozen=True)
class Config:
    """A model and the protocol it is evaluated on.  ``preset`` names the
    configuration the weights were trained under (the card's)."""

    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    preset: str = "custom"


def config3_prf() -> ModelConfig:
    """The model part of ``bin_tpu``'s ``config3_prf`` preset, the
    architecture of the released weights."""
    return ModelConfig(name="prf", num_levels=2, use_convlstm=True,
                       cycle_level=True, base_features=128)


def _override(cfg: ModelConfig, name: str, value: Any) -> ModelConfig:
    """A copy of ``cfg`` with field ``name`` set to ``value``, parsed to the
    field's type (``bin_tpu/config.py`` ``_override``)."""
    if name not in {f.name for f in dataclasses.fields(cfg)}:
        raise KeyError(f"config has no field {name!r}")
    current = getattr(cfg, name)
    if current is not None and not isinstance(value, type(current)):
        if isinstance(current, bool):
            value = str(value).lower() in ("1", "true", "yes")
        elif isinstance(current, (int, float)):
            value = type(current)(value)
        elif isinstance(current, tuple):
            sep = [v for v in str(value).replace("(", "").replace(")", "")
                   .split(",") if v]
            elem = type(current[0]) if current else int
            value = tuple(elem(v) for v in sep)
    return dataclasses.replace(cfg, **{name: value})


def apply_model_overrides(model_cfg: ModelConfig,
                          overrides: list[str]) -> ModelConfig:
    """Apply ``--set`` strings to a :class:`ModelConfig`.

    A released card records the training-time configuration; deployment
    knobs such as ``model.conv_int8`` or ``model.dtype`` are layered on
    top.  Takes ``model.conv_int8=true`` and bare ``conv_int8=true``."""
    for s in overrides:
        if "=" not in s:
            raise ValueError(f"overrides must be KEY=VALUE, got {s!r}")
        path, value = s.split("=", 1)
        if path.startswith("model."):
            path = path[len("model."):]
        model_cfg = _override(model_cfg, path, value)
    return model_cfg


# ``bin_tpu`` fields whose code paths the port does not have yet
_NOT_PORTED = {
    "data.root": "folder datasets (bin_tpu/data/frames.py, video.py)",
    "data.dataset": "folder datasets (bin_tpu/data/frames.py, video.py)",
    "data.eval_list": "folder datasets (bin_tpu/data/frames.py, video.py)",
    "parallel.": "meshes (bin_tpu/parallel, ROADMAP queue 1 item 6)",
}


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``--set`` strings to a :class:`Config`: ``data.KEY=V`` to its
    ``DataConfig``, anything else through ``apply_model_overrides``.  A
    field of a path the port does not have (folder datasets, meshes)
    raises ``ValueError`` naming it."""
    model_sets = []
    data = cfg.data
    for s in overrides:
        if "=" not in s:
            raise ValueError(f"overrides must be KEY=VALUE, got {s!r}")
        path, value = s.split("=", 1)
        for prefix, what in _NOT_PORTED.items():
            if path.startswith(prefix):
                raise ValueError(f"{path}: {what} are not ported to "
                                 "bin_tpu_torch yet")
        if path.startswith("data."):
            data = _override(data, path[len("data."):], value)
        else:
            model_sets.append(s)
    return dataclasses.replace(
        cfg, model=apply_model_overrides(cfg.model, model_sets), data=data)
