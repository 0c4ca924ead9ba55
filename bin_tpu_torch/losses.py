"""Training losses: deep-supervised Charbonnier, cycle consistency and the
gradient-domain perceptual surrogate (``bin_tpu/losses.py``).

Every term is computed in fp32.  The Charbonnier and cycle terms are
pointwise, so they read the packed frames directly; the perceptual term is
spatial and unpacks its operands first.  ``perceptual_mode="vgg"`` raises:
the VGG-16 extractor (``bin_tpu/perceptual.py``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from bin_tpu_torch.config import LossConfig
from bin_tpu_torch.models.pyramid import level_output_times
from bin_tpu_torch.ops.pixel_shuffle import depth_to_space

__all__ = ["charbonnier", "gradient_loss", "pyramid_loss",
           "build_perceptual_fn"]


def build_perceptual_fn(cfg: LossConfig) -> Callable | None:
    """The configured perceptual distance (pred, target) -> scalar on
    unpacked RGB in [0, 1], or None when the term is off."""
    if cfg.perceptual_weight <= 0.0:
        return None
    if cfg.perceptual_mode == "gradient":
        return lambda p, t: gradient_loss(p, t, cfg.charbonnier_eps)
    if cfg.perceptual_mode == "vgg":
        raise ValueError("loss.perceptual_mode=vgg: the VGG-16 extractor "
                         "(bin_tpu/perceptual.py) is not ported to "
                         "bin_tpu_torch yet (ROADMAP queue 1 item 5)")
    raise ValueError(f"unknown perceptual_mode {cfg.perceptual_mode!r}")


def charbonnier(pred: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Mean of sqrt(diff^2 + eps^2), in fp32."""
    diff = pred.float() - target.float()
    return torch.sqrt(diff * diff + eps * eps).mean()


def _spatial_grads(x: torch.Tensor):
    return (x[..., 1:, :, :] - x[..., :-1, :, :],
            x[..., :, 1:, :] - x[..., :, :-1, :])


def gradient_loss(pred: torch.Tensor, target: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Charbonnier on spatial gradients: the weight-free perceptual
    surrogate."""
    pgy, pgx = _spatial_grads(pred)
    tgy, tgx = _spatial_grads(target)
    return charbonnier(pgy, tgy, eps) + charbonnier(pgx, tgx, eps)


def pyramid_loss(outputs: list, gt: torch.Tensor, cfg: LossConfig,
                 window_size: int, stem_factor: int = 1,
                 perceptual_fn: Callable | None = None):
    """Deep-supervised loss of one window.

    outputs[l]: (B, window_size-1-l, h, w, C) at the level's times; gt: (B,
    2*window_size-1, h, w, C) on the window's output grid, in the same
    (packed or unpacked) domain.  Returns (total, aux) with aux keys
    ``loss_level{l}``, ``loss_perceptual`` (when the term is on),
    ``loss_cycle`` (when it is) and ``loss_total``."""
    total = torch.zeros((), dtype=torch.float32, device=gt.device)
    aux: dict[str, torch.Tensor] = {}
    center_preds = []
    # cycle timestamp: level l emits times of parity l, so the tied pair
    # shares parity: the middle time of the deepest odd level
    # (bin_tpu/losses.py:88-99)
    odd_levels = [li + 1 for li in range(len(outputs)) if (li + 1) % 2 == 1]
    center_t = None
    if len(odd_levels) >= 2:
        deep_times = level_output_times(odd_levels[-1], window_size)
        center_t = deep_times[len(deep_times) // 2]
    perceptual_sum = torch.zeros((), dtype=torch.float32, device=gt.device)
    for idx, out in enumerate(outputs):
        level = idx + 1
        times = level_output_times(level, window_size)
        # the level's times step by 2: a strided view, no index tensor
        level_gt = gt[:, times[0]:times[-1] + 1:2]
        weight = cfg.level_weights[idx] if idx < len(cfg.level_weights) else 1.0
        term = charbonnier(out, level_gt, cfg.charbonnier_eps)
        if cfg.perceptual_weight > 0.0:
            fn = perceptual_fn or (
                lambda p, t: gradient_loss(p, t, cfg.charbonnier_eps))
            p_term = fn(depth_to_space(out.float(), stem_factor),
                        depth_to_space(level_gt.float(), stem_factor))
            perceptual_sum = perceptual_sum + p_term
            term = term + cfg.perceptual_weight * p_term
        aux[f"loss_level{level}"] = term
        total = total + weight * term
        if center_t is not None and center_t in times:
            center_preds.append(out[:, times.index(center_t)])
    if cfg.perceptual_weight > 0.0:
        aux["loss_perceptual"] = perceptual_sum
    if cfg.cycle_weight > 0.0 and len(center_preds) >= 2:
        cyc = charbonnier(center_preds[0], center_preds[-1],
                          cfg.charbonnier_eps)
        aux["loss_cycle"] = cyc
        total = total + cfg.cycle_weight * cyc
    aux["loss_total"] = total
    return total, aux
