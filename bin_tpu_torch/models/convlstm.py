"""ConvLSTM cell (``bin_tpu/models/convlstm.py``).

One 3x3 conv over ``cat([x, h])`` gives all four gates, ordered i, f, g, o;
the state update runs in fp32 through ``fused_lstm_gates``, which is the
kernel K1 for CUDA tensors.  With ``quant`` (the int8 serving mode's
``conv_int8_lstm``) the gate conv is ``Int8GateConv``; under QAT it stays
float, as in ``bin_tpu``.  On a band of the frame's height (``Model.
shard_height``) the carries are the band's rows and the gate conv takes
its halo rows (each int8 part its own, after its quantize).  With
``quant="calib"`` the cell records the abs-max of its two inputs, ``x``
and the carried ``h``, each on its own (``amax_x``, ``amax_h``: the
scales of ``Int8GateConv``'s two parts).
"""

from __future__ import annotations

import torch
from torch import nn

from bin_tpu_torch.models.layers import (Conv, int8_conv_on, pack_int8_conv,
                                         record_amax)
from bin_tpu_torch.ops.lstm_gates import fused_lstm_gates

__all__ = ["ConvLSTMCell", "Int8GateConv", "init_state"]


def init_state(batch: int, height: int, width: int, features: int,
               device: torch.device | str = "cpu"):
    """Zero (h, c) carry for one cell, NHWC fp32."""
    shape = (batch, height, width, features)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


class Int8GateConv(Conv):
    """The gate conv over ``cat([x, h])`` as two int8 PTQ convs: conv(x, Kx)
    with the bias, in fp32, then conv(h, Kh) without, added to it in fp32
    and cast once, Kx = ``weight[:, :cx]``.  Each part has its own
    per-channel weight scales and its own activation scale
    (``act_scales``, static or None): one per-tensor scale over the concat
    would crush the smaller of the two (``bin_tpu``'s split).  Holds
    ``weight`` and ``bias`` as ``Conv``; ``quantize`` as ``Int8Conv``."""

    def __init__(self, cx: int, ch: int, cout: int):
        super().__init__(cx + ch, cout)
        self.cx = cx
        self.act_scales: tuple = (None, None)
        self.packed: tuple | None = None

    @torch.no_grad()
    def quantize(self) -> None:
        sx, sh = self.act_scales
        self.packed = (
            pack_int8_conv(self.weight[:, :self.cx], self.bias, sx),
            pack_int8_conv(self.weight[:, self.cx:], None, sh))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        if self.packed is None:
            raise RuntimeError("Int8GateConv.quantize() was not called after "
                               "the weights were loaded")
        (qx, kx, bias, sx), (qh, kh, _, sh) = self.packed
        gx = int8_conv_on(self.halo, x, qx, kx, bias, 1, (1, 1), sx,
                          torch.float32)
        return int8_conv_on(self.halo, h, qh, kh, None, 1, (1, 1), sh,
                            h.dtype, addend=gx)


class ConvLSTMCell(nn.Module):
    def __init__(self, in_features: int, features: int,
                 forget_bias: float = 1.0, dtype: torch.dtype = torch.float32,
                 quant=False):
        super().__init__()
        self.dtype = dtype
        self.forget_bias = forget_bias
        self.calibrate = quant == "calib"
        self.amax_x: torch.Tensor | None = None
        self.amax_h: torch.Tensor | None = None
        if quant and not self.calibrate:
            self.gates = Int8GateConv(in_features, features, 4 * features)
        else:
            self.gates = Conv(in_features + features, 4 * features)

    def forward(self, x: torch.Tensor, state):
        """x (B, h, w, Cin), state ((B, h, w, F), (B, h, w, F)) -> (h', c').
        The int8 gate conv quantizes h from its cast to the compute dtype,
        as ``bin_tpu``."""
        h, c = state
        if self.calibrate:
            record_amax(self.amax_x, x)
            record_amax(self.amax_h, h)
        x, h = x.to(self.dtype), h.to(self.dtype)
        if isinstance(self.gates, Int8GateConv):
            gates = self.gates(x, h)
        else:
            gates = self.gates(torch.cat([x, h], dim=-1))
        return fused_lstm_gates(gates, c, self.forget_bias)
