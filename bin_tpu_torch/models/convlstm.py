"""ConvLSTM cell (``bin_tpu/models/convlstm.py``).

One 3x3 conv over ``cat([x, h])`` gives all four gates, ordered i, f, g, o;
the state update runs in fp32 through ``fused_lstm_gates``, which is the
kernel K1 for CUDA tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from bin_tpu_torch.models.layers import Conv
from bin_tpu_torch.ops.lstm_gates import fused_lstm_gates

__all__ = ["ConvLSTMCell", "init_state"]


def init_state(batch: int, height: int, width: int, features: int,
               device: torch.device | str = "cpu"):
    """Zero (h, c) carry for one cell, NHWC fp32."""
    shape = (batch, height, width, features)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


class ConvLSTMCell(nn.Module):
    def __init__(self, in_features: int, features: int,
                 forget_bias: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.forget_bias = forget_bias
        self.gates = Conv(in_features + features, 4 * features)

    def forward(self, x: torch.Tensor, state):
        """x (B, h, w, Cin), state ((B, h, w, F), (B, h, w, F)) -> (h', c')."""
        h, c = state
        inp = torch.cat([x.to(self.dtype), h.to(self.dtype)], dim=-1)
        return fused_lstm_gates(self.gates(inp), c, self.forget_bias)
