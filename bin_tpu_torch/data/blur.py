"""Blur synthesis over a folder of 240 fps frames, a copy of
``bin_tpu/data/blur.py`` (``python -m bin_tpu_torch.cli prep``).

Input tree:  src_root/<clip_id>/<frame>.npy|.png   (240 fps sharp frames)
Output tree: dst_root/{blurry,sharp}/<clip_id>/NNNNNN.{npy|png}

Each blurry key frame is the mean of ``taps`` consecutive frames, keys
``stride`` frames apart; the sharp frames are the ground truth at the keys
and midway between them (``synthetic.gt_indices``), the pairing
``FrameFolderSource`` reads.  ``.npy`` (uint8) is the default output;
``.png`` needs PIL.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bin_tpu_torch.data.frames import load_frame, pil_image
from bin_tpu_torch.data.synthetic import gt_indices

__all__ = ["synthesize_tree", "prep_cli"]


def _list_raw_clips(src_root: str) -> dict[str, list[str]]:
    exts = (".npy", ".png", ".jpg", ".jpeg", ".bmp")
    clips = {}
    for clip_id in sorted(os.listdir(src_root)):
        d = os.path.join(src_root, clip_id)
        if os.path.isdir(d):
            frames = sorted(f for f in os.listdir(d) if f.lower().endswith(exts))
            if frames:
                clips[clip_id] = [os.path.join(d, f) for f in frames]
    if not clips:
        raise FileNotFoundError(f"no frame folders under {src_root}")
    return clips


def _save(path: str, arr: np.ndarray, fmt: str) -> None:
    if fmt == "npy":
        np.save(path + ".npy", (arr * 255.0 + 0.5).astype(np.uint8))
    else:
        pil_image().fromarray(
            (arr * 255.0 + 0.5).astype(np.uint8)).save(path + ".png")


def synthesize_tree(src_root: str, dst_root: str, taps: int = 11,
                    stride: int = 8, fmt: str = "npy",
                    verbose: bool = True) -> int:
    """Blur every clip of ``src_root`` into ``dst_root``; returns the
    number of clips written.  A running window keeps ``taps`` frames of a
    clip in memory, so clips of any length fit."""
    clips = _list_raw_clips(src_root)
    total = 0
    for clip_id, paths in clips.items():
        n = len(paths)
        num_keys = (n - taps) // stride + 1
        if num_keys < 2:
            if verbose:
                print(f"skip {clip_id}: {n} frames < taps+stride")
            continue
        bdir = os.path.join(dst_root, "blurry", clip_id)
        sdir = os.path.join(dst_root, "sharp", clip_id)
        os.makedirs(bdir, exist_ok=True)
        os.makedirs(sdir, exist_ok=True)

        gts = {int(idx): t for t, idx in
               enumerate(gt_indices(num_keys, taps, stride))}
        window: list[np.ndarray] = []
        key = 0
        for i in range(n):
            frame = load_frame(paths[i])
            if i in gts:
                _save(os.path.join(sdir, f"{gts[i]:06d}"), frame, fmt)
            window.append(frame)
            if len(window) > taps:
                window.pop(0)
            if (len(window) == taps and (i - taps + 1) % stride == 0
                    and key < num_keys and i - taps + 1 == key * stride):
                _save(os.path.join(bdir, f"{key:06d}"),
                      np.mean(window, axis=0), fmt)
                key += 1
        total += 1
        if verbose:
            print(f"{clip_id}: {num_keys} blurry keys, {2 * num_keys - 1} sharp GT")
    return total


def prep_cli(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="Synthesize a blurry/sharp training tree from 240fps frames.")
    p.add_argument("src_root", help="folder of <clip_id>/ sharp 240fps frames")
    p.add_argument("dst_root", help="output root (blurry/ + sharp/ written here)")
    p.add_argument("--taps", type=int, default=11)
    p.add_argument("--stride", type=int, default=8)
    p.add_argument("--format", choices=("npy", "png"), default="npy")
    args = p.parse_args(argv)
    n = synthesize_tree(args.src_root, args.dst_root, args.taps, args.stride,
                        args.format)
    print(f"wrote {n} clips to {args.dst_root}")
