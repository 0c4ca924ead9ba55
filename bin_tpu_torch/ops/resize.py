"""Bilinear 2x upsample (``bin_tpu/ops/resize.py``'s ``upsample2x``).

Half-pixel centres, edge-clamped: ``F.interpolate(align_corners=False)``,
which ``bin_tpu``'s shifted-sum form equals.  Used by the unfused reference
of the decoder upsample only; the model runs the fused phase-bank conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["upsample2x"]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C), bilinear, half-pixel centres."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)
