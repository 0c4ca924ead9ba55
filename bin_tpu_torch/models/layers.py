"""Shared building blocks (``bin_tpu/models/layers.py``).

Activations are NHWC tensors at every module boundary, as in ``bin_tpu``.
A conv views its input as NCHW (``permute``, no copy), which for an NHWC
tensor is the channels_last layout that cuDNN runs natively, and hands its
channels_last output back as a contiguous NHWC view.  Each conv holds its
weight as (O, I, kh, kw) under the flax module's name (``Conv_0``, ...), so
``weights.params_from_flax`` fills the ``state_dict`` one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bin_tpu_torch.ops.fused_upsample import phase_kernel, upsample2x_conv

__all__ = ["Conv", "ConvBlock", "ResBlock", "Downsample", "Upsample"]


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA SAME padding of one axis: (before, after).  For a stride-2
    3x3 conv over an even size that is (0, 1), not torch's (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv(padding="SAME")`` on NHWC tensors."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        k, s = self.kernel_size[0], self.stride[0]
        pt, pb = _same_pad(x.shape[2], k, s)
        pl, pr = _same_pad(x.shape[3], k, s)
        if pt == pb and pl == pr:
            y = F.conv2d(x, self.weight, self.bias, s, (pt, pl))
        else:
            y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), self.weight, self.bias, s)
        return y.permute(0, 2, 3, 1)


class ConvBlock(nn.Module):
    """conv3x3 + LeakyReLU."""

    def __init__(self, cin: int, cout: int, slope: float = 0.1,
                 stride: int = 1):
        super().__init__()
        self.slope = slope
        self.Conv_0 = Conv(cin, cout, 3, stride)

    def forward(self, x):
        return F.leaky_relu(self.Conv_0(x), self.slope)


class Downsample(ConvBlock):
    """Stride-2 conv3x3 (flax SAME padding) + LeakyReLU."""

    def __init__(self, cin: int, cout: int, slope: float = 0.1):
        super().__init__(cin, cout, slope, stride=2)


class ResBlock(nn.Module):
    """conv-LeakyReLU-conv with identity skip."""

    def __init__(self, features: int, slope: float = 0.1):
        super().__init__()
        self.slope = slope
        self.Conv_0 = Conv(features, features)
        self.Conv_1 = Conv(features, features)

    def forward(self, x):
        return x + self.Conv_1(F.leaky_relu(self.Conv_0(x), self.slope))


class Upsample(nn.Module):
    """Bilinear 2x upsample + replicate-padded conv3x3 + LeakyReLU, run as
    the fused phase-bank conv.  ``Conv_0`` holds the conv's own weight;
    ``prepare`` builds the bank from it once the weights are in place."""

    def __init__(self, cin: int, cout: int, slope: float = 0.1):
        super().__init__()
        self.slope = slope
        self.Conv_0 = Conv(cin, cout)
        self.register_buffer("bank", None, persistent=False)
        self.register_buffer("bias4", None, persistent=False)

    @torch.no_grad()
    def prepare(self) -> None:
        self.bank = phase_kernel(self.Conv_0.weight).contiguous(
            memory_format=torch.channels_last)
        self.bias4 = self.Conv_0.bias.repeat(4)

    def forward(self, x):
        if self.bank is None:
            raise RuntimeError("Upsample.prepare() was not called after the "
                               "weights were loaded")
        return F.leaky_relu(upsample2x_conv(x, self.bank, self.bias4),
                            self.slope)
