"""Shared building blocks (``bin_tpu/models/layers.py``).

Activations are NHWC tensors at every module boundary, as in ``bin_tpu``.
A conv views its input as NCHW (``permute``, no copy), which for an NHWC
tensor is the channels_last layout that cuDNN runs natively, and hands its
channels_last output back as a contiguous NHWC view.  Each conv holds its
weight as (O, I, kh, kw) under the flax module's name (``Conv_0``, ...), so
``weights.params_from_flax`` fills the ``state_dict`` one to one.

The ``quant`` mode of the 3x3 convs that ``bin_tpu`` routes through
``_conv3x3_maybe_quant`` (``bin_tpu/models/layers.py:34-87``): ``True``,
the int8 serving mode (``ModelConfig.conv_int8``), makes those whose Cin is
at least ``conv_int8_min_cin`` ``Int8Conv``s, the same parameters run as
the int8 PTQ conv of ``ops/quant.py``; ``"qat"`` (``conv_int8_qat``) makes
them ``QATConv``s, trained through ``fake_quant_conv``; ``"calib"``
(``conv_int8_calibrate``) makes every one of them, whatever its Cin, a
``CalibConv``, a float conv that records the abs-max of its input.  The
output of an int8 or QAT conv is cast to the compute dtype before the
LeakyReLU and the residual add, as in ``bin_tpu``.

A conv takes the pass that follows it in a block: ``slope`` (a LeakyReLU)
and ``residual`` (added after it), ``ops/quant.epilogue_ref``.  The float
``Conv`` runs them eagerly; the ``Int8Conv`` in its kernel's epilogue.

A float conv casts its weight and bias to its input's dtype (the compute
dtype) per call, as flax's ``dtype``/``param_dtype`` do: in the inference
form the parameters are already in that dtype and the cast is a no-op; in
the training form (``Model.train_params``) they stay fp32 and trainable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bin_tpu_torch.ops.fused_upsample import phase_kernel, upsample2x_conv
from bin_tpu_torch.ops.quant import (epilogue_ref, fake_quant_conv,
                                     int8_conv, quantize_weight)

__all__ = ["Conv", "Int8Conv", "QATConv", "CalibConv", "record_amax",
           "pack_int8_conv", "conv3x3", "ConvBlock", "ResBlock",
           "Downsample", "Upsample"]


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

    def forward(self, x: torch.Tensor, slope: float | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        weight, bias = self.weight.to(x.dtype), self.bias.to(x.dtype)
        k, s = self.kernel_size[0], self.stride[0]
        pt, pb = _same_pad(x.shape[2], k, s)
        pl, pr = _same_pad(x.shape[3], k, s)
        if pt == pb and pl == pr:
            y = F.conv2d(x, weight, bias, s, (pt, pl))
        else:
            y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, bias, s)
        return epilogue_ref(y.permute(0, 2, 3, 1), slope, residual)


def pack_int8_conv(weight: torch.Tensor, bias: torch.Tensor | None,
                   act_scale: float | None) -> tuple:
    """(qweight, kscale, bias, ascale) of one int8 conv, from the fp32
    parameters; ``ascale`` a one-value tensor on the weight's device, or
    None for the dynamic scale."""
    qweight, kscale = quantize_weight(weight)
    if bias is not None:
        bias = bias.detach().float().clone()
    if act_scale is not None:
        act_scale = torch.tensor(act_scale, dtype=torch.float32,
                                 device=weight.device)
    return qweight, kscale, bias, act_scale


class Int8Conv(Conv):
    """A flax SAME 3x3 conv run as the int8 PTQ conv (``ops/quant.py``).

    It holds ``weight`` and ``bias`` as ``Conv`` does, so the ``state_dict``
    is the same.  ``quantize`` packs them from the fp32 parameters; call it
    before the module is cast to the compute dtype.  The packed tensors
    are plain attributes, not buffers, so that the cast leaves the scales
    and the bias in fp32.  ``act_scale`` is the static activation scale,
    set from the scales sidecar by the pyramid, or None for the dynamic
    per-tensor abs-max."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride)
        self.act_scale: float | None = None
        self.packed: tuple | None = None

    @torch.no_grad()
    def quantize(self) -> None:
        self.packed = pack_int8_conv(self.weight, self.bias, self.act_scale)

    def forward(self, x: torch.Tensor, slope: float | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.packed is None:
            raise RuntimeError("Int8Conv.quantize() was not called after the "
                               "weights were loaded")
        qweight, kscale, bias, ascale = self.packed
        s = self.stride[0]
        pad = (_same_pad(x.shape[1], 3, s)[0], _same_pad(x.shape[2], 3, s)[0])
        return int8_conv(x, qweight, kscale, bias, s, pad, ascale, x.dtype,
                         slope=slope, residual=residual)


class QATConv(Conv):
    """A flax SAME 3x3 conv trained through ``fake_quant_conv``: the int8
    serving conv's quantizer in the forward, a straight-through gradient
    in the backward.  The same parameters as ``Conv``.  In the training
    form it quantizes the fp32 weight, as ``bin_tpu`` does; in the
    inference form (``Model.load_params``) the weight it quantizes is
    already cast to the compute dtype."""

    def forward(self, x: torch.Tensor, slope: float | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        s = self.stride[0]
        pad = (_same_pad(x.shape[1], 3, s)[0], _same_pad(x.shape[2], 3, s)[0])
        y = fake_quant_conv(x, self.weight, self.bias, s, pad).to(x.dtype)
        return epilogue_ref(y, slope, residual)


def record_amax(stat: torch.Tensor, x: torch.Tensor) -> None:
    """stat = max(stat, max |x|), in place on the device (no host sync).
    The abs-max of a bf16 tensor taken to fp32 equals that of its fp32
    copy, which is not made."""
    torch.maximum(stat, x.detach().abs().amax().float(), out=stat)


class CalibConv(Conv):
    """A float conv that records the abs-max of its inputs into ``amax``
    (a one-value fp32 tensor the pyramid sets, keyed by the conv's flax
    path), max-reduced over every call: ``bin_tpu``'s ``quant_stats``."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride)
        self.amax: torch.Tensor | None = None

    def forward(self, x: torch.Tensor, slope: float | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        record_amax(self.amax, x)
        return super().forward(x, slope, residual)


def conv3x3(cin: int, cout: int, stride: int = 1, quant=False,
            quant_min_cin: int = 0) -> Conv:
    """A 3x3 conv of ``quant`` mode False, True (``Int8Conv``), "qat"
    (``QATConv``) or "calib" (``CalibConv``, at every Cin); the int8 and
    QAT convs only where Cin >= ``quant_min_cin`` (decided from the static
    Cin, as ``bin_tpu`` does from the traced shape), the float ``Conv``
    elsewhere."""
    if quant == "calib":
        return CalibConv(cin, cout, stride)
    if quant and cin >= quant_min_cin:
        return (QATConv(cin, cout, 3, stride) if quant == "qat"
                else Int8Conv(cin, cout, stride))
    return Conv(cin, cout, 3, stride)


class ConvBlock(nn.Module):
    """conv3x3 + LeakyReLU."""

    def __init__(self, cin: int, cout: int, slope: float = 0.1,
                 stride: int = 1, quant=False, quant_min_cin: int = 0):
        super().__init__()
        self.slope = slope
        self.Conv_0 = conv3x3(cin, cout, stride, quant, quant_min_cin)

    def forward(self, x):
        return self.Conv_0(x, slope=self.slope)


class Downsample(ConvBlock):
    """Stride-2 conv3x3 (flax SAME padding) + LeakyReLU."""

    def __init__(self, cin: int, cout: int, slope: float = 0.1,
                 quant=False, quant_min_cin: int = 0):
        super().__init__(cin, cout, slope, 2, quant, quant_min_cin)


class ResBlock(nn.Module):
    """conv-LeakyReLU-conv with identity skip."""

    def __init__(self, features: int, slope: float = 0.1,
                 quant=False, quant_min_cin: int = 0):
        super().__init__()
        self.slope = slope
        self.Conv_0 = conv3x3(features, features, 1, quant, quant_min_cin)
        self.Conv_1 = conv3x3(features, features, 1, quant, quant_min_cin)

    def forward(self, x):
        return self.Conv_1(self.Conv_0(x, slope=self.slope), residual=x)


class Upsample(nn.Module):
    """Bilinear 2x upsample + replicate-padded conv3x3 + LeakyReLU, run as
    the fused phase-bank conv.  ``Conv_0`` holds the conv's own weight;
    ``prepare`` builds the bank from it once the weights are in place, for
    inference.  With grad enabled, or without a prepared bank, the bank is
    built from ``Conv_0.weight`` per call, so the gradient reaches the
    conv's weight through ``phase_kernel`` (``bin_tpu``'s einsum)."""

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
        bank, bias4 = self.bank, self.bias4
        if bank is None or torch.is_grad_enabled():
            bank = phase_kernel(self.Conv_0.weight.to(x.dtype)).contiguous(
                memory_format=torch.channels_last)
            bias4 = self.Conv_0.bias.to(x.dtype).repeat(4)
        return F.leaky_relu(upsample2x_conv(x, bank, bias4), self.slope)
