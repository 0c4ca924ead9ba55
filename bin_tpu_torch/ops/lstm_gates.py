"""ConvLSTM gate update: the CUDA kernel K1 and its plain PyTorch version.

Counterpart of ``bin_tpu/ops/pallas/lstm_gates.py`` (the Pallas kernel) and
of ``bin_tpu.models.convlstm.lstm_gate_math`` (the function it computes).
The kernel is ``bin_tpu_torch/csrc/lstm_gates.cu``.  The backward pass
belongs to the training slice and is not here.
"""

from __future__ import annotations

import torch

from bin_tpu_torch.ops import native

__all__ = ["fused_lstm_gates", "lstm_gate_math_ref", "launches"]

launches = 0  # kernel launches by fused_lstm_gates


def lstm_gate_math_ref(gates: torch.Tensor, c: torch.Tensor,
                       forget_bias: float = 1.0):
    """(..., 4F) gate pre-activations, ordered i, f, g, o, and the (..., F)
    cell -> (h', c') in fp32."""
    gates = gates.float()
    c = c.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_h, new_c


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor,
                     forget_bias: float = 1.0):
    """``lstm_gate_math_ref`` in one pass: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (or an error, never the plain
    version).

    On CUDA: ``gates`` (..., 4F) bf16 or fp32, contiguous, i.e. the
    channels_last output of the gate conv viewed as NHWC; ``c`` (..., F)
    fp32, contiguous.  Returns new (h', c'), fp32, shaped like ``c``."""
    if gates.device.type == "cpu" and c.device.type == "cpu":
        return lstm_gate_math_ref(gates, c, forget_bias)
    if not (gates.is_cuda and c.is_cuda and gates.device == c.device):
        raise ValueError(f"fused_lstm_gates: gates on {gates.device}, c on "
                         f"{c.device}; both must be on one CUDA device or "
                         "both on the CPU")
    feat = c.shape[-1]
    if gates.shape[:-1] != c.shape[:-1] or gates.shape[-1] != 4 * feat:
        raise ValueError(f"fused_lstm_gates: gates {tuple(gates.shape)} do "
                         f"not hold four blocks of c {tuple(c.shape)}")
    if gates.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_lstm_gates: gates dtype {gates.dtype}; "
                         "the kernel takes bfloat16 or float32")
    if c.dtype != torch.float32:
        raise ValueError(f"fused_lstm_gates: c dtype {c.dtype}; the kernel "
                         "takes float32")
    if not (gates.is_contiguous() and c.is_contiguous()):
        raise ValueError("fused_lstm_gates: gates and c must be contiguous "
                         "(..., C) tensors (channels_last)")
    h_new = torch.empty_like(c)
    c_new = torch.empty_like(c)
    if c.numel() == 0:
        return h_new, c_new
    lib = native.library()
    with torch.cuda.device(c.device):
        err = lib.btt_lstm_gates(
            gates.data_ptr(), int(gates.dtype == torch.bfloat16),
            c.data_ptr(), h_new.data_ptr(), c_new.data_ptr(),
            c.numel() // feat, feat, float(forget_bias),
            native.stream(c.device))
    native.check(err, "btt_lstm_gates")
    global launches
    launches += 1
    return h_new, c_new
