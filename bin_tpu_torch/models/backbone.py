"""Backbone: encoder-decoder that synthesizes one sharp frame from two
packed frames (``bin_tpu/models/backbone.py``).

The pair is concatenated on channels, encoded with skips and stride-2
downsamples, the ConvLSTM context is added at the bottleneck through a 1x1
conv, residual blocks run there, and the decoder upsamples with the fused
phase-bank conv.  A zero-init tail predicts a residual that is added, in
fp32, to the average of the two inputs.  With ``quant`` the 3x3 convs of
the head and the ResBlocks, Downsamples and ConvBlocks whose Cin is at least
``quant_min_cin`` are int8 convs; the upsamples, the context projection and
the tail stay float.
"""

from __future__ import annotations

import torch
from torch import nn

from bin_tpu_torch.models.layers import (Conv, ConvBlock, Downsample,
                                         ResBlock, Upsample)

__all__ = ["Backbone"]


class Backbone(nn.Module):
    def __init__(self, base_features: int = 64,
                 channel_mult: tuple[int, ...] = (1, 2, 4),
                 num_res_blocks: int = 4, slope: float = 0.1,
                 stem_factor: int = 1, context_features: int | None = None,
                 dtype: torch.dtype = torch.float32, quant: bool = False,
                 quant_min_cin: int = 0):
        super().__init__()
        self.dtype = dtype
        chans = [base_features * m for m in channel_mult]
        cpk = 3 * stem_factor ** 2  # packed channels of one frame
        q = dict(quant=quant, quant_min_cin=quant_min_cin)
        self.head = ConvBlock(2 * cpk, chans[0], slope, **q)
        self.encs, self.downs, self.mids, self.ups, self.decs = [], [], [], [], []
        for i, ch in enumerate(chans[:-1]):
            self.encs.append(self._add(f"enc_{i}", ResBlock(ch, slope, **q)))
            self.downs.append(self._add(
                f"down_{i}", Downsample(ch, chans[i + 1], slope, **q)))
        self.context_proj = (None if context_features is None else
                             Conv(context_features, chans[-1], 1))
        for i in range(num_res_blocks):
            self.mids.append(self._add(f"mid_{i}",
                                       ResBlock(chans[-1], slope, **q)))
        for i, ch in enumerate(chans[:-1]):
            self.ups.append(self._add(f"up_{i}",
                                      Upsample(chans[i + 1], ch, slope)))
            self.decs.append(self._add(f"dec_{i}", ResBlock(ch, slope, **q)))
        self.tail = Conv(chans[0], cpk)
        nn.init.zeros_(self.tail.weight)
        nn.init.zeros_(self.tail.bias)

    def _add(self, name: str, module: nn.Module) -> nn.Module:
        self.add_module(name, module)  # flax's child name, for the weights
        return module

    def forward(self, frame_a: torch.Tensor, frame_b: torch.Tensor,
                context: torch.Tensor | None = None,
                clamp_output: bool = False):
        """Two PACKED frames (B, h, w, 3f^2) -> (packed sharp frame in the
        compute dtype, bottleneck features).  ``clamp_output`` is the
        producer-side clamp to [-0.5, 1.5] of inference."""
        x = torch.cat([frame_a, frame_b], dim=-1).to(self.dtype)
        x = self.head(x)
        skips = []
        for enc, down in zip(self.encs, self.downs):
            x = enc(x)
            skips.append(x)
            x = down(x)
        if context is not None:
            x = x + self.context_proj(context.to(self.dtype))
        for mid in self.mids:
            x = mid(x)
        feats = x
        for i in reversed(range(len(skips))):
            x = self.ups[i](x) + skips[i]
            x = self.decs[i](x)
        residual = self.tail(x)
        sharp = 0.5 * (frame_a.float() + frame_b.float()) + residual.float()
        if clamp_output:
            sharp = sharp.clamp(-0.5, 1.5)
        return sharp.to(self.dtype), feats
