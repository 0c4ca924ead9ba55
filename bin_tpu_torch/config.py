"""Configuration of the PyTorch port.

A copy of ``bin_tpu/config.py``'s dataclass tree, without the fields the
port has no code path for: the ``ModelConfig`` fields inference and
training read, with ``apply_model_overrides`` for deployment knobs layered
over a weights card; the ``DataConfig`` fields of evaluation, whose
defaults are the release card's pinned protocol, of the training stream
and of the frame-folder datasets; and ``LossConfig``, ``OptimConfig``, ``ParallelConfig``,
``CheckpointConfig`` and ``LogConfig``, with the named presets
(``PRESETS``, ``get_config``).  The port keeps its own copy instead of
importing the JAX package, so that it runs where JAX is not installed.
Fields that only select between bit-exact layouts on the TPU
(``s2d_via_conv``, ``d2s_via_conv``, ``d2s_final_via_conv``,
``fused_upsample``), the master-weight dtype (``param_dtype``, always fp32),
an int8 option no serving mode uses (``conv_int8_mse_clip``) and Orbax's
``checkpoint.async_save`` are not carried: a weights card that names them
loads without them.  Training
fields whose code paths are not ported yet are carried so that presets and
cards load, and ``training.trainer.train`` raises on them, as on the
inference-only modes (``unported_training_fields``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

__all__ = ["ModelConfig", "DataConfig", "LossConfig", "OptimConfig",
           "ParallelConfig", "CheckpointConfig", "LogConfig", "Config",
           "config3_prf", "PRESETS", "get_config", "apply_model_overrides",
           "apply_overrides", "unported_training_fields"]


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
    conv_int8_qat: bool = False    # training-time fake quant (QAT) of
                                   # the convs int8 would take
    conv_int8_calibrate: bool = False  # calibration pass: float convs that
                                   # record their inputs' abs-max
    remat: bool = False            # recompute each window's forward in the
                                   # backward pass (torch.utils.checkpoint)


@dataclass(frozen=True)
class LossConfig:
    """Multi-frame Charbonnier + cycle (+ perceptual) terms."""

    charbonnier_eps: float = 1e-6
    level_weights: tuple[float, ...] = (1.0, 1.0, 1.0)  # per pyramid level
    cycle_weight: float = 0.1
    perceptual_weight: float = 0.0
    perceptual_mode: str = "gradient"  # "gradient" | "vgg"
    vgg_weights: str = ""
    vgg_layers: tuple[str, ...] = ("relu1_2", "relu2_2", "relu3_3")


@dataclass(frozen=True)
class DataConfig:
    """The eval protocol, the training stream and the frame-folder
    dataset (``bin_tpu/config.py`` ``DataConfig``).  The eval defaults are
    the protocol under which the release card's quality was measured
    (``weights/prf_ema_r4.card.json`` ``eval_protocol``), so numbers are
    comparable across runs; each preset sets ``bin_tpu``'s ``eval_size``.
    The training defaults are ``bin_tpu``'s."""

    dataset: str = "synthetic"     # "synthetic" | "adobe240" | "gopro"
    root: str = ""                 # frame-folder tree (blurry/ + sharp/)
    train_list: str = ""           # clip list restricting the train clips
    eval_list: str = ""            # ... and the eval clips; "" = all
    crop_size: tuple[int, int] = (128, 128)  # train crop (H, W)
    seq_len: int = 4               # key frames per training sample
    batch_size: int = 8
    random_flip: bool = True
    transfer_u8: bool = True       # ship uint8 crops, normalize on the device
    loader: str = "thread"         # "thread" | "grain": the deterministic,
                                   # resumable loader (data/loader.py)
    num_workers: int = 0           # its worker processes (> 0 implies it)
    prefetch: int = 2
    eval_size: tuple[int, int] = (256, 256)  # eval resolution (H, W)
    eval_num_clips: int = 16       # clips per eval pass
    eval_num_keys: int = 12        # blurry keys per eval clip; 0 = whole
                                   # clips (folder datasets only)
    eval_seed: int = 9999          # synthetic eval stream seed
    blur_taps: int = 11            # sharp frames averaged into one blurry frame
    blur_stride: int = 8           # stride between blurry frames
    synthetic_style: str = "textured"  # "textured" | "smooth"


@dataclass(frozen=True)
class OptimConfig:
    """Adam with step decay, global-norm clipping, non-finite step skipping
    and an optional EMA of the parameters."""

    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0      # > 0: AdamW
    lr_warmup_steps: int = 0       # linear 0 -> lr before the decay
    lr_decay_steps: int = 50_000
    lr_decay_rate: float = 0.5
    grad_clip_norm: float = 1.0
    skip_nonfinite: bool = True    # drop steps with NaN/Inf gradients
    ema_decay: float = 0.0         # > 0 tracks an EMA of the parameters
    grad_accum_steps: int = 1      # microbatches per optimizer update
    num_steps: int = 200_000


@dataclass(frozen=True)
class ParallelConfig:
    """The mesh of ``bin_tpu``: here the data axis is the ranks of a
    ``torch.distributed`` group (``parallel/``; -1 = all of them), and the
    spatial axis stays 1."""

    data_axis_size: int = 1
    spatial_axis_size: int = 1
    axis_names: tuple[str, str] = ("data", "spatial")


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "checkpoints"
    save_interval_steps: int = 1000
    keep_last_n: int = 3


@dataclass(frozen=True)
class LogConfig:
    jsonl_path: str = "metrics.jsonl"
    log_interval_steps: int = 50
    eval_interval_steps: int = 0   # > 0: in-training eval, keeps best.npz
    eval_clips: int = 4            # clips per in-training eval
    profile_dir: str = ""          # torch.profiler trace of steps 10-14
    debug_nans: bool = False       # raise on the first non-finite loss
                                   # or gradient
    stall_timeout_s: float = 3600.0  # > 0: exit 91 after this long
                                   # without train-loop progress


@dataclass(frozen=True)
class Config:
    """A model, its training recipe and the protocol it is evaluated on.
    ``preset`` names the configuration (for weights, the card's)."""

    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    preset: str = "custom"
    seed: int = 0
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()
    parallel: ParallelConfig = ParallelConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    log: LogConfig = LogConfig()


def config3_prf() -> ModelConfig:
    """The model part of ``bin_tpu``'s ``config3_prf`` preset, the
    architecture of the released weights."""
    return ModelConfig(name="prf", num_levels=2, use_convlstm=True,
                       cycle_level=True, base_features=128)


def _preset(name: str, model: ModelConfig, seq_len: int, batch_size: int,
            loss: LossConfig = LossConfig(), eval_size=(352, 640),
            dataset: str = "synthetic", **kw) -> Config:
    """A preset of ``bin_tpu/config.py``: its model, training crop (128x128
    in all of them), eval size, dataset and loss; the other eval fields
    keep the pinned protocol's defaults, as in ``bin_tpu``."""
    return Config(preset=name, model=model, loss=loss,
                  data=DataConfig(crop_size=(128, 128), seq_len=seq_len,
                                  batch_size=batch_size, dataset=dataset,
                                  eval_size=eval_size), **kw)


def _presets() -> dict:
    prf = config3_prf()
    prf3 = _preset("config3_prf", prf, 6, 4)
    return {
        "config1_backbone_128": _preset(
            "config1_backbone_128",
            ModelConfig(name="backbone", num_levels=1, use_convlstm=False,
                        cycle_level=False, base_features=64, stem_factor=1),
            4, 4, LossConfig(level_weights=(1.0,), cycle_weight=0.0)),
        "config2_pyramid": _preset(
            "config2_pyramid",
            ModelConfig(name="pyramid", num_levels=2, use_convlstm=False,
                        cycle_level=True, base_features=128), 4, 8),
        "config3_prf": prf3,
        # + the gradient perceptual term and EMA 0.999
        "config3_prf_extended": dataclasses.replace(
            prf3, preset="config3_prf_extended",
            loss=LossConfig(perceptual_weight=0.5,
                            perceptual_mode="gradient"),
            optim=OptimConfig(ema_decay=0.999)),
        "config4_gopro_720p": _preset("config4_gopro_720p", prf, 6, 4,
                                      eval_size=(720, 1280), dataset="gopro"),
        "config5_v5e_streaming": _preset(
            "config5_v5e_streaming",
            dataclasses.replace(prf, base_features=256, stem_factor=4,
                                dtype="bfloat16"), 6, 8,
            eval_size=(720, 1280), dataset="gopro",
            parallel=ParallelConfig(data_axis_size=-1)),
    }


PRESETS = tuple(_presets())


def get_config(preset: str, overrides: list[str] | None = None) -> Config:
    """A named preset of ``bin_tpu/config.py`` with ``--set`` overrides."""
    presets = _presets()
    if preset not in presets:
        raise KeyError(f"unknown preset {preset!r}; available: "
                       f"{sorted(presets)}")
    return apply_overrides(presets[preset], overrides or [])


def unported_training_fields(cfg: Config) -> list[str]:
    """The settings of ``cfg`` that ``train`` refuses: training code paths
    the port does not have yet, each with where it stands in ROADMAP.md,
    and modes that have no training (int8 PTQ, calibration)."""
    rules = [
        (cfg.parallel.spatial_axis_size > 1,
         "parallel.spatial_axis_size > 1: spatial (height) sharding, with "
         "its halo exchange (ROADMAP queue 1, the next slice)"),
        (cfg.model.conv_int8,
         "model.conv_int8: PTQ is inference only, it has no backward; "
         "train with model.conv_int8_qat (QAT)"),
        (cfg.model.conv_int8_calibrate,
         "model.conv_int8_calibrate: calibration is a forward pass, run "
         "by python -m bin_tpu_torch.calibrate"),
        (cfg.model.dtype not in ("float32", "bfloat16"),
         f"model.dtype={cfg.model.dtype}: training computes in float32 "
         "or bfloat16"),
    ]
    return [what for bad, what in rules if bad]


def _override(cfg: Any, name: str, value: Any) -> Any:
    """A copy of ``cfg`` with field ``name`` (dotted for a nested section)
    set to ``value``, parsed to the field's type (``bin_tpu/config.py``
    ``_override``)."""
    head, _, rest = name.partition(".")
    if head not in {f.name for f in dataclasses.fields(cfg)}:
        raise KeyError(f"config has no field {head!r}")
    if rest:
        return dataclasses.replace(
            cfg, **{head: _override(getattr(cfg, head), rest, value)})
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


# ``bin_tpu`` fields whose code paths the port does not have yet, refused
# where they are set to anything but their default
_NOT_PORTED = {
    "parallel.spatial_axis_size": (
        "1", "spatial (height) sharding of the meshes, with its halo "
        "exchange (ROADMAP queue 1, the next slice)"),
}
_SECTIONS = ("data.", "loss.", "optim.", "parallel.", "checkpoint.", "log.")


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``--set`` strings to a :class:`Config`: ``data.KEY=V``,
    ``loss.``, ``optim.``, ``parallel.``, ``checkpoint.``, ``log.``,
    ``seed`` and ``preset`` to their fields, anything else through
    ``apply_model_overrides``.  A field of a path the port does not have
    (spatial sharding) set to another value than its default raises
    ``ValueError`` naming it."""
    model_sets = []
    for s in overrides:
        if "=" not in s:
            raise ValueError(f"overrides must be KEY=VALUE, got {s!r}")
        path, value = s.split("=", 1)
        if path in _NOT_PORTED and value.strip() != _NOT_PORTED[path][0]:
            raise ValueError(f"{path}={value}: {_NOT_PORTED[path][1]} is "
                             "not ported to bin_tpu_torch yet")
        if path.startswith(_SECTIONS) or path in ("seed", "preset"):
            cfg = _override(cfg, path, value)
        else:
            model_sets.append(s)
    return dataclasses.replace(
        cfg, model=apply_model_overrides(cfg.model, model_sets))
