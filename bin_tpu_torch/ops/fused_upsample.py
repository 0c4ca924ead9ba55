"""Fused bilinear-2x-upsample + 3x3 conv as one low-resolution phase conv
(``bin_tpu/ops/fused_upsample.py``).

Bilinear upsampling is linear, so ``conv3x3(upsample2x(x))`` with a
replicate border equals one 3x3 conv of the replicate-padded low-resolution
``x`` against a bank of 4*Cout filters (one per output phase), followed by a
depth-to-space.  The bank depends on the weights only, so the model builds
it once, when weights are loaded (``phase_kernel``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from bin_tpu_torch.ops.pixel_shuffle import depth_to_space
from bin_tpu_torch.ops.resize import upsample2x

__all__ = ["phase_kernel", "upsample2x_conv", "upsample2x_conv_reference"]

# A[p, e, d]: weight of tap x[i+d-1] in y[2i+p+(e-1)] (1D, interior).
_A = np.array([[[0.75, 0.25, 0.0],
                [0.25, 0.75, 0.0],
                [0.0, 0.75, 0.25]],
               [[0.25, 0.75, 0.0],
                [0.0, 0.75, 0.25],
                [0.0, 0.25, 0.75]]], np.float32)


@functools.lru_cache(maxsize=8)
def _phase_taps(device: torch.device) -> torch.Tensor:
    """``_A`` on ``device``, copied there once: a copy from pageable host
    memory waits for the device, and training builds the bank every step.
    Made outside inference mode, so that a first call from an inference
    pass (an in-training eval) caches a tensor autograd can save."""
    with torch.inference_mode(False):
        return torch.from_numpy(_A).to(device)


def phase_kernel(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) conv weight -> (4*Cout, Cin, 3, 3) phase bank.

    Output channel (py, px, co), pixel-major as ``depth_to_space`` reads it.
    The weight comes already cast to the compute dtype, as in ``bin_tpu``;
    the sums run in fp32 and the bank is cast back to that dtype."""
    a = _phase_taps(weight.device)
    k = torch.einsum("ped,qgf,oieg->pqoidf", a, a, weight.float())
    co, ci = weight.shape[:2]
    return k.reshape(4 * co, ci, 3, 3).to(weight.dtype)


def upsample2x_conv(x: torch.Tensor, bank: torch.Tensor,
                    bias4: torch.Tensor, pad_rows: bool = True) -> torch.Tensor:
    """``conv3x3_replicate(upsample2x(x)) + bias`` in one pass.

    x (B, N, M, Cin); ``bank`` from ``phase_kernel``; ``bias4`` the bias
    tiled four times.  Returns (B, 2N, 2M, Cout).  ``pad_rows=False``: x
    already holds one row of padding above and below (a band with its halo
    rows), and gives (B, 2(N-2), 2M, Cout)."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, int(pad_rows), int(pad_rows)),
               mode="replicate")
    core = F.conv2d(xp, bank, bias4)
    return depth_to_space(core.permute(0, 2, 3, 1), 2)


def upsample2x_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Unfused reference: upsample2x, replicate pad, 3x3 VALID conv."""
    up = F.pad(upsample2x(x).permute(0, 3, 1, 2), (1, 1, 1, 1),
               mode="replicate")
    return F.conv2d(up, weight, bias).permute(0, 2, 3, 1)
