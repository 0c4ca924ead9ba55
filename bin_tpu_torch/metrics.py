"""Image quality metrics: PSNR and SSIM (``bin_tpu/metrics.py``).

The same definitions as ``bin_tpu``'s, in plain PyTorch on the tensors'
device: the standard Wang et al. 2004 SSIM, as
``skimage.metrics.structural_similarity`` with ``gaussian_weights=True,
sigma=1.5, use_sample_covariance=False``:

  * 11x11 Gaussian window, sigma = 1.5 (truncated at the window edge,
    normalized to sum 1)
  * K1 = 0.01, K2 = 0.03 on data_range = 1.0 (images in [0, 1])
  * covariance normalized by N (not N-1)
  * computed per channel then averaged; no edge cropping beyond the valid
    convolution region

All functions take images shaped (..., H, W, C) in [0, 1] and compute in
fp32 whatever the input dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["psnr", "ssim", "gaussian_kernel"]


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the trailing (H, W, C) dims, in dB."""
    pred, target = pred.float(), target.float()
    mse = (pred - target).square().mean(dim=(-3, -2, -1))
    mse = mse.clamp_min(1e-12)  # avoid -inf on identical images
    return 10.0 * torch.log10(max_val * max_val / mse)


@functools.lru_cache(maxsize=8)
def gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """1-D Gaussian window, normalized to sum to 1 (separable SSIM filter)."""
    offsets = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (offsets / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _filter2d_separable(x: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Valid-mode separable 2-D filtering over (N, H, W, C), as sums of
    shifted slices in fp32.

    Not a conv: on the card cuDNN may run an fp32 conv in TF32
    (``torch.backends.cudnn.allow_tf32``, on by default), which drops the
    window's low bits; variances then go negative and SSIM comes out above
    1 (``bin_tpu/metrics.py`` saw the same at reduced precision).  Plain
    fp32 multiplies and adds do not depend on any global setting."""
    size = window.shape[0]
    taps = [float(w) for w in window]
    h = x.shape[1] - size + 1
    y = taps[0] * x[:, :h]
    for i in range(1, size):
        y = y + taps[i] * x[:, i:i + h]
    w = x.shape[2] - size + 1
    out = taps[0] * y[:, :, :w]
    for i in range(1, size):
        out = out + taps[i] * y[:, :, i:i + w]
    return out


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over the trailing (H, W, C) dims.

    Accepts (..., H, W, C); returns shape (...,)."""
    if pred.shape[-3] < window_size or pred.shape[-2] < window_size:
        # the valid-windowed maps would be empty and the mean silently NaN
        raise ValueError(
            f"ssim needs H, W >= window_size ({window_size}); got "
            f"{pred.shape[-3]}x{pred.shape[-2]}")
    batch_shape = pred.shape[:-3]
    x = pred.float().reshape((-1,) + tuple(pred.shape[-3:]))
    y = target.float().reshape((-1,) + tuple(target.shape[-3:]))

    window = gaussian_kernel(window_size, sigma)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mu_x = _filter2d_separable(x, window)
    mu_y = _filter2d_separable(y, window)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    # E[x^2] - E[x]^2 with N (not N-1) normalization
    sigma_xx = _filter2d_separable(x * x, window) - mu_xx
    sigma_yy = _filter2d_separable(y * y, window) - mu_yy
    sigma_xy = _filter2d_separable(x * y, window) - mu_xy

    num = (2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_xx + sigma_yy + c2)
    out = (num / den).mean(dim=(1, 2, 3))
    return out.reshape(batch_shape)
