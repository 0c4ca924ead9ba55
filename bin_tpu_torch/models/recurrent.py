"""Sliding-window recurrence over a clip and assembly of the 2x-rate video
(``bin_tpu/models/recurrent.py``).

``bin_tpu`` scans the windows with ``jax.lax.scan``; here they run in a
Python loop, with the ConvLSTM states carried from one window to the next.
The clip is cast to the compute dtype and packed once, before the loop.
``clip_loss`` is the training loss over a clip's windows; with
``model.remat`` each window's forward is recomputed in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does in ``bin_tpu``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.utils.checkpoint

from bin_tpu_torch.config import LossConfig, ModelConfig
from bin_tpu_torch.ops.pixel_shuffle import depth_to_space, space_to_depth

__all__ = ["num_windows", "scan_windows", "clip_loss", "assembly_plan",
           "assemble_clip"]


def num_windows(num_keys: int, window_size: int) -> int:
    n = num_keys - window_size + 1
    if n < 1:
        raise ValueError(f"clip of {num_keys} keys shorter than window {window_size}")
    return n


def scan_windows(apply_fn: Callable, blurry: torch.Tensor, init_states: list,
                 window_size: int, stem_factor: int,
                 compute_dtype: torch.dtype):
    """Run the pyramid over every sliding window of a clip.

    apply_fn(window, states) -> (outputs, new_states), window packed;
    blurry (B, K, H, W, 3).
    Returns (stacked_outputs, final_states): stacked_outputs[l] is (S, B,
    P_l, H/f, W/f, 3f^2) packed, S the number of windows."""
    n = num_windows(blurry.shape[1], window_size)
    # cast first, then pack: the cast commutes with the permutation
    blurry = space_to_depth(blurry.to(compute_dtype).contiguous(), stem_factor)
    states = init_states
    per_window = []
    for s in range(n):
        outputs, states = apply_fn(blurry[:, s:s + window_size], states)
        per_window.append(outputs)
    stacked = [torch.stack(level) for level in zip(*per_window)]
    return stacked, states


def clip_loss(apply_fn: Callable, blurry: torch.Tensor, sharp: torch.Tensor,
              init_states: list, model_cfg: ModelConfig, loss_cfg: LossConfig,
              perceptual_fn: Callable | None = None):
    """Mean deep-supervised loss over the windows of a clip
    (``bin_tpu/models/recurrent.py:73-114``).

    apply_fn(window, states) -> (outputs, new_states), the pyramid's
    training forward; blurry (B, K, H, W, 3) and sharp (B, 2K-1, H, W, 3)
    fp32.  The blurry clip is cast to the compute dtype and packed once;
    the ground truth is packed once, in fp32.  Returns (loss, aux), aux the
    mean over windows of each of ``pyramid_loss``'s terms."""
    from bin_tpu_torch.losses import pyramid_loss

    k = model_cfg.window_size
    n = num_windows(blurry.shape[1], k)
    f = model_cfg.stem_factor
    blurry = space_to_depth(
        blurry.to(getattr(torch, model_cfg.dtype)).contiguous(), f)
    sharp = space_to_depth(sharp.float().contiguous(), f)
    states = init_states
    losses, auxs = [], []
    for s in range(n):
        window = blurry[:, s:s + k]
        if model_cfg.remat:
            outputs, states = torch.utils.checkpoint.checkpoint(
                apply_fn, window, states, use_reentrant=False)
        else:
            outputs, states = apply_fn(window, states)
        loss, aux = pyramid_loss(outputs, sharp[:, 2 * s:2 * s + 2 * k - 1],
                                 loss_cfg, k, stem_factor=f,
                                 perceptual_fn=perceptual_fn)
        losses.append(loss)
        auxs.append(aux)
    mean_aux = {key: torch.stack([a[key] for a in auxs]).mean()
                for key in auxs[0]}
    return torch.stack(losses).mean(), mean_aux


def assembly_plan(num_keys: int, window_size: int,
                  levels: int) -> dict[int, tuple[int, int, int]]:
    """Static plan: output time t -> (level_idx, window, pair_index).

    For every reachable output timestamp, pick the deepest pyramid level
    whose parity matches t, then the window placing t most centrally in
    that level (ties: the later window, with more ConvLSTM history).  The
    boundary times 0 and 2*(num_keys-1) are never predicted."""
    s_count = num_windows(num_keys, window_size)
    plan: dict[int, tuple[int, int, int]] = {}
    for t in range(1, 2 * (num_keys - 1)):
        for li in range(levels - 1, -1, -1):
            level = li + 1
            if (t - level) % 2:
                continue
            p = window_size - 1 - li
            best = None
            for s in range(s_count):
                j = (t - 2 * s - level) // 2
                if 0 <= j < p:
                    key = (abs(j - (p - 1) / 2), -s)
                    if best is None or key < best[0]:
                        best = (key, s, j)
            if best is not None:
                plan[t] = (li, best[1], best[2])
                break
    return plan


def assemble_clip(stacked_outputs: list[torch.Tensor], num_keys: int,
                  window_size: int, stem_factor: int):
    """The 2x-rate sharp video from the stacked packed outputs.

    Returns (video, times): video (B, T, H, W, 3) fp32, unpacked once here,
    and the global output timestamps (ascending numpy array)."""
    plan = assembly_plan(num_keys, window_size, len(stacked_outputs))
    times = sorted(plan)
    frames = [stacked_outputs[plan[t][0]][plan[t][1], :, plan[t][2]]
              for t in times]
    video = torch.stack(frames, dim=1)
    return depth_to_space(video.float(), stem_factor), np.asarray(times)
