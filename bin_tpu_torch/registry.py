"""Model factory: config -> ``Model`` handle (``bin_tpu/registry.py``).

``Model`` bundles the pyramid module, on one device and in the compute
dtype, with the clip-level entry points.  Its public layout is ``bin_tpu``'s:
clips (B, K, H, W, 3) in, videos (B, T, H, W, 3) out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bin_tpu_torch.config import ModelConfig
from bin_tpu_torch.models import recurrent
from bin_tpu_torch.models.pyramid import BINPyramid, initial_state
from bin_tpu_torch.weights import params_from_flax

__all__ = ["Model", "build_model", "MODEL_NAMES"]

MODEL_NAMES = ("backbone", "pyramid", "prf")


def _normalize(cfg: ModelConfig) -> ModelConfig:
    """Make the model name authoritative over the sub-flags."""
    if cfg.name == "backbone":
        return dataclasses.replace(cfg, num_levels=1, use_convlstm=False,
                                   cycle_level=False)
    if cfg.name == "pyramid":
        return dataclasses.replace(cfg, use_convlstm=False)
    if cfg.name == "prf":
        return dataclasses.replace(cfg, use_convlstm=True)
    raise KeyError(f"unknown model {cfg.name!r}; available: {MODEL_NAMES}")


def _device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return device


class Model:
    """The pyramid module of one config, on one device."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = _device(device)
        self.dtype = getattr(torch, cfg.dtype)
        with self.device:
            self.module = BINPyramid(cfg)
        self.module.eval()

    def load_params(self, params: dict) -> "Model":
        """Take a flax parameter tree (numpy leaves, e.g. from
        ``load_weights``), pack the int8 convs from the fp32 parameters,
        cast the rest to the compute dtype in channels_last and build the
        upsample phase banks."""
        self.module.load_state_dict(params_from_flax(params), strict=True)
        self.module.quantize()
        self.module.to(dtype=self.dtype, memory_format=torch.channels_last)
        self.module.requires_grad_(False)
        self.module.prepare()
        return self

    def initial_state(self, batch: int, height: int, width: int) -> list:
        return initial_state(self.cfg, batch, height, width, self.device)

    @torch.inference_mode()
    def infer_clip(self, blurry: torch.Tensor) -> tuple[torch.Tensor, np.ndarray]:
        """Joint deblur + 2x interpolation of a clip.

        Returns (video, times): (B, T, H, W, 3) fp32 and the global 2x-grid
        timestamps covered."""
        b, k, h, w, _ = blurry.shape
        outputs, _ = recurrent.scan_windows(
            self.module, blurry.to(self.device), self.initial_state(b, h, w),
            self.cfg.window_size, self.cfg.stem_factor, self.dtype)
        return recurrent.assemble_clip(outputs, k, self.cfg.window_size,
                                       self.cfg.stem_factor)


def build_model(cfg: ModelConfig, device: torch.device | str = "cuda") -> Model:
    return Model(_normalize(cfg), device)

