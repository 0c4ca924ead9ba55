"""BIN/PRF pyramid over one sliding window of key frames
(``bin_tpu/models/pyramid.py``).

Level l runs its backbone on every adjacent pair of the previous level's
frames at once, with the pairs folded into the batch.  Each level's
ConvLSTM hidden state is the bottleneck context of all its pairs, and is
updated from the mean of the level's bottleneck features.

In the int8 serving mode the static activation scales are read once, when
the module is built, and each int8 conv takes its own by its flax path
(``level_1/enc_1/Conv_0``, ``lstm_2/gates_x``): the module's qualified name
with ``.`` turned into ``/``.  A missing key raises there, as ``bin_tpu``
raises at trace time.
"""

from __future__ import annotations

import torch
from torch import nn

from bin_tpu_torch.config import ModelConfig
from bin_tpu_torch.models.backbone import Backbone
from bin_tpu_torch.models.convlstm import (ConvLSTMCell, Int8GateConv,
                                           init_state)
from bin_tpu_torch.models.layers import Int8Conv, Upsample
from bin_tpu_torch.ops.pixel_shuffle import space_to_depth
from bin_tpu_torch.ops.quant import load_act_scales, lookup_act_scale

__all__ = ["BINPyramid", "total_levels", "level_output_times",
           "initial_state"]


def total_levels(cfg: ModelConfig) -> int:
    n = cfg.num_levels + (1 if cfg.cycle_level else 0)
    if n > cfg.window_size - 1:
        raise ValueError(
            f"{n} pyramid levels need window_size > {n}, got {cfg.window_size}")
    return n


def level_output_times(level: int, window_size: int) -> list[int]:
    """Output timestamps (2x grid, window-local) of 1-indexed ``level``."""
    return list(range(level, 2 * (window_size - 1) - level + 1, 2))


def bottleneck_factor(cfg: ModelConfig) -> int:
    return cfg.stem_factor * 2 ** (len(cfg.channel_mult) - 1)


def initial_state(cfg: ModelConfig, batch: int, height: int, width: int,
                  device: torch.device | str = "cpu") -> list:
    """Zero ConvLSTM carries for a (batch, height, width) clip; [] without
    recurrence."""
    if not cfg.use_convlstm:
        return []
    f = bottleneck_factor(cfg)
    return [init_state(batch, height // f, width // f, cfg.convlstm_features,
                       device) for _ in range(total_levels(cfg))]


class BINPyramid(nn.Module):
    """One pyramid forward over a window; children are named as the flax
    module's (``level_1``, ``lstm_1``, ...)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        n = total_levels(cfg)
        ctx = cfg.convlstm_features if cfg.use_convlstm else None
        feat = cfg.base_features * cfg.channel_mult[-1]
        self.backbones, self.lstms = [], []
        for l in range(1, n + 1):
            bb = Backbone(cfg.base_features, tuple(cfg.channel_mult),
                          cfg.num_res_blocks, cfg.lrelu_slope, cfg.stem_factor,
                          context_features=ctx, dtype=self.dtype,
                          quant=cfg.conv_int8,
                          quant_min_cin=cfg.conv_int8_min_cin)
            self.add_module(f"level_{l}", bb)
            self.backbones.append(bb)
            if cfg.use_convlstm:
                cell = ConvLSTMCell(feat, cfg.convlstm_features,
                                    dtype=self.dtype,
                                    quant=cfg.conv_int8 and cfg.conv_int8_lstm)
                self.add_module(f"lstm_{l}", cell)
                self.lstms.append(cell)
        if cfg.conv_int8 and cfg.conv_int8_static:
            scales = load_act_scales(cfg.conv_int8_static)
            for name, m in self.named_modules():
                key = name.replace(".", "/")
                if isinstance(m, Int8Conv):
                    m.act_scale = lookup_act_scale(scales, key)
                elif isinstance(m, Int8GateConv):
                    m.act_scales = (lookup_act_scale(scales, key + "_x"),
                                    lookup_act_scale(scales, key + "_h"))

    @torch.no_grad()
    def quantize(self) -> None:
        """Pack every int8 conv's weights; call after the fp32 weights are
        loaded and before the cast to the compute dtype."""
        for m in self.modules():
            if isinstance(m, (Int8Conv, Int8GateConv)):
                m.quantize()

    @torch.no_grad()
    def prepare(self) -> None:
        """Build what depends on the weights alone (the upsample phase
        banks); call after the weights are loaded and cast."""
        for m in self.modules():
            if isinstance(m, Upsample):
                m.prepare()

    def forward(self, window: torch.Tensor, states: list,
                producer_clamp: bool = True):
        """window (B, K, H/f, W/f, 3f^2), packed in the compute dtype, or
        unpacked (B, K, H, W, 3), then cast and packed here; states as from
        ``initial_state``.

        ``producer_clamp`` (inference, the default): the stability clamp
        runs in the producing backbone's fp32 tail, so the emitted frames
        are clamped to [-0.5, 1.5].  ``producer_clamp=False`` (training,
        ``bin_tpu/models/pyramid.py:156-162``): levels > 0 clamp what they
        consume, and supervision sees the raw estimates.

        Returns (outputs, new_states): outputs[l] is (B, K-1-l, H/f, W/f,
        3f^2), packed frames at the level's timestamps, in the compute
        dtype."""
        c = self.cfg
        if window.shape[-1] == 3:
            # cast before packing: the cast commutes with the permutation
            window = space_to_depth(window.to(self.dtype).contiguous(),
                                    c.stem_factor)
        b, k, h, w, cpk = window.shape
        if k != c.window_size:
            raise ValueError(f"window has {k} keys, config says {c.window_size}")
        frames = window
        outputs, new_states = [], []
        for idx, backbone in enumerate(self.backbones):
            p = frames.shape[1] - 1  # pairs at this level
            if c.clamp_intermediate and not producer_clamp and idx > 0:
                frames = frames.clamp(-0.5, 1.5)
            pa = frames[:, :-1].reshape(b * p, h, w, cpk)
            pb = frames[:, 1:].reshape(b * p, h, w, cpk)
            ctx = (states[idx][0].repeat_interleave(p, dim=0)
                   if c.use_convlstm else None)
            sharp, feats = backbone(
                pa, pb, context=ctx,
                clamp_output=c.clamp_intermediate and producer_clamp)
            sharp = sharp.reshape(b, p, h, w, cpk)
            outputs.append(sharp)
            if c.use_convlstm:
                fh, fw, fc = feats.shape[1:]
                # a bf16 mean accumulates in fp32, as in bin_tpu
                feats = feats.reshape(b, p, fh, fw, fc).mean(dim=1)
                new_states.append(self.lstms[idx](feats, states[idx]))
            frames = sharp
        return outputs, new_states
