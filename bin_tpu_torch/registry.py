"""Model factory: config -> ``Model`` handle (``bin_tpu/registry.py``).

``Model`` bundles the pyramid module, on one device, with the clip-level
entry points.  Its public layout is ``bin_tpu``'s: clips (B, K, H, W, 3)
in, videos (B, T, H, W, 3) out.  A model takes its parameters in one of two
forms: ``load_params`` for inference (cast to the compute dtype, int8 convs
packed, upsample banks built, frozen) or ``train_params`` for training
(fp32 and trainable; ``loss_clip``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from bin_tpu_torch.config import LossConfig, ModelConfig
from bin_tpu_torch.models import recurrent
from bin_tpu_torch.models.pyramid import BINPyramid, initial_state
from bin_tpu_torch.weights import flax_from_params, params_from_flax

__all__ = ["Model", "build_model", "MODEL_NAMES"]

MODEL_NAMES = ("backbone", "pyramid", "prf")


def _normalize(cfg: ModelConfig) -> ModelConfig:
    """Make the model name authoritative over the sub-flags, and the int8
    serving mode over QAT.

    The card of a QAT fine-tune's export (``best.npz``) keeps
    ``conv_int8_qat``, and the serving entries build from the card: with
    ``conv_int8`` set they must run the int8 convs that QAT trained for,
    not its fake quantizers (``bin_tpu``'s pyramid ranks QAT first).
    Training refuses ``conv_int8`` (``Model.train_params``), so QAT keeps
    its place there."""
    if cfg.conv_int8 and cfg.conv_int8_qat:
        cfg = dataclasses.replace(cfg, conv_int8_qat=False)
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

    def init(self, seed: int = 0) -> dict:
        """Fresh parameters as a flax tree of fp32 numpy arrays, drawn from
        flax's distributions (``bin_tpu/models/layers.py:18``) by a torch
        generator seeded with ``seed``: the same distributions as
        ``bin_tpu``'s ``Model.init``, not the same values.  Conv kernels are
        variance-scaling 2.0, fan-in, truncated normal; biases and the
        backbone's tail (``backbone.py:129``) are zero."""
        gen = torch.Generator().manual_seed(seed)
        lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
        out = {}
        for name, p in self.module.named_parameters():
            value = torch.zeros(p.shape)
            if name.endswith(".weight") and not name.endswith("tail.weight"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                # jax.random.truncated_normal on [-2, 2], rescaled to unit
                # variance as flax's variance_scaling does
                std = math.sqrt(2.0 / fan_in) / .87962566103423978
                u = torch.rand(p.shape, generator=gen) * (hi - lo) + lo
                value = (math.sqrt(2) * torch.erfinv(u)).clamp(-2, 2) * std
            out[name] = value
        return flax_from_params(out)

    def train_params(self, params: dict) -> "Model":
        """Take a flax parameter tree as the training form: fp32 trainable
        parameters in channels_last, no int8 packing, no prepared banks
        (each conv casts its weight to the compute dtype per call; a QAT
        conv fake-quantizes the fp32 weight)."""
        if self.cfg.conv_int8:
            raise ValueError("model.conv_int8: the int8 convs have no "
                             "backward (PTQ is inference only); train with "
                             "model.conv_int8_qat (QAT)")
        self.module.load_state_dict(params_from_flax(params), strict=True)
        self.module.to(dtype=torch.float32, memory_format=torch.channels_last)
        self.module.requires_grad_(True)
        self.module.train()
        return self

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


    def loss_clip(self, blurry: torch.Tensor, sharp: torch.Tensor,
                  loss_cfg: LossConfig, perceptual_fn=None):
        """The training loss of a clip: (loss, aux), differentiable in the
        module's parameters (``bin_tpu/registry.py`` ``loss_clip``).
        blurry (B, K, H, W, 3), sharp (B, 2K-1, H, W, 3), fp32; the pyramid
        runs with the consume-side clamp of training."""
        b, _, h, w, _ = blurry.shape
        return recurrent.clip_loss(
            functools.partial(self.module, producer_clamp=False),
            blurry.to(self.device), sharp.to(self.device),
            self.initial_state(b, h, w), self.cfg, loss_cfg, perceptual_fn)


def build_model(cfg: ModelConfig, device: torch.device | str = "cuda") -> Model:
    return Model(_normalize(cfg), device)

