"""Frame-folder datasets, a copy of ``bin_tpu/data/frames.py``.

The tree that ``python -m bin_tpu_torch.cli prep`` (``data/blur.py``)
writes from 240 fps frames, the Adobe240/GoPro layout:

    root/
      blurry/<clip_id>/000000.npy   # 30 fps blurry key frames
      sharp/<clip_id>/000000.npy    # 2x-rate sharp ground truth
                                    # (2*keys-1 frames)

Frames are ``.npy`` (H, W, 3) uint8 or float32, or images (``.png``,
``.jpg``, ``.bmp``), which need PIL; it is imported only where an image is
decoded or a frame is resized, and a missing PIL raises an error that
names it.  ``.npy`` frames at their native size need no PIL.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

__all__ = ["FrameFolderSource", "list_clips", "load_frame", "load_frame_u8",
           "read_clip_list"]

_EXTS = (".npy", ".png", ".jpg", ".jpeg", ".bmp")


def pil_image():
    """PIL's ``Image`` module, or an ImportError that names the package."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding or resizing image frames needs PIL "
                          "(the Pillow package); .npy frames at their "
                          "native size do not") from e
    return Image


def read_clip_list(path: str) -> list[str]:
    """A sequence list file: one clip id per line, '#' comments and blank
    lines skipped, order kept (the standard train/test splits)."""
    with open(path) as f:
        ids = [line.split("#", 1)[0].strip() for line in f]
    ids = [i for i in ids if i]
    if not ids:
        raise ValueError(f"clip list {path} is empty")
    dupes = {i for i in ids if ids.count(i) > 1}
    if dupes:
        raise ValueError(f"clip list {path} has duplicates: {sorted(dupes)}")
    return ids


def list_clips(root: str, split: str) -> dict[str, list[str]]:
    """clip_id -> ordered frame paths under root/<split>/<clip_id>/."""
    base = os.path.join(root, split)
    if not os.path.isdir(base):
        raise FileNotFoundError(f"dataset folder missing: {base}")
    clips = {}
    for clip_id in sorted(os.listdir(base)):
        d = os.path.join(base, clip_id)
        if not os.path.isdir(d):
            continue
        frames = sorted(f for f in os.listdir(d) if f.lower().endswith(_EXTS))
        if frames:
            clips[clip_id] = [os.path.join(d, f) for f in frames]
    if not clips:
        raise FileNotFoundError(f"no clips with frames under {base}")
    return clips


def load_frame(path: str) -> np.ndarray:
    """One frame as (H, W, 3) float32 in [0, 1]."""
    arr = load_frame_u8(path, allow_float=True)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return np.ascontiguousarray(arr.astype(np.float32))


def load_frame_u8(path: str, allow_float: bool = False) -> np.ndarray:
    """One frame as (H, W, 3) uint8 (float ``.npy`` frames are quantized
    unless ``allow_float``)."""
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        arr = np.asarray(pil_image().open(path).convert("RGB"))
    if arr.dtype != np.uint8 and not allow_float:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(arr)


class FrameFolderSource:
    """Sliding chunks over a blurry/sharp folder tree.

    Sample ``i`` is ``num_keys`` consecutive blurry key frames and their
    2*num_keys-1 sharp frames; chunks start every ``chunk_stride`` keys.
    ``num_keys=None`` gives one whole-clip sample per clip.
    ``resize_to=(H, W)``: bilinear resize on load, per channel in float32
    (PIL mode 'F'), only for frames of another size.  ``raw_u8``: uint8
    frames for the training crop (not with ``resize_to``).  ``clip_list``:
    a list file restricting and ordering the clips; each must exist.
    ``cache_frames``: an LRU cache of decoded frames, rebuilt empty in a
    process that unpickles the source (a loader's worker)."""

    def __init__(self, root: str, num_keys: int | None = 4,
                 chunk_stride: int = 2, cache_frames: bool = False,
                 resize_to: tuple[int, int] | None = None,
                 raw_u8: bool = False, clip_list: str = ""):
        self.blurry = list_clips(root, "blurry")
        self.sharp = list_clips(root, "sharp")
        if clip_list:
            ids = read_clip_list(clip_list)
            absent = [i for i in ids if i not in self.blurry]
            if absent:
                raise ValueError(
                    f"clip list {clip_list} names clips missing on disk: "
                    f"{absent[:5]} (have: {sorted(self.blurry)[:5]}...)")
            self.blurry = {i: self.blurry[i] for i in ids}
            self.sharp = {i: self.sharp[i] for i in ids if i in self.sharp}
        self.resize_to = resize_to
        self.raw_u8 = raw_u8
        if raw_u8 and resize_to is not None:
            raise ValueError("raw_u8 and resize_to are mutually exclusive")
        missing = set(self.blurry) ^ set(self.sharp)
        if missing:
            raise ValueError(f"blurry/sharp clip mismatch: {sorted(missing)[:5]}")
        self.num_keys = num_keys
        self.cache_frames = cache_frames
        self._load = self._loader()

        self.index: list[tuple[str, int, int]] = []  # (clip, key_start, keys)
        for clip_id, frames in self.blurry.items():
            # a sharp track shorter than 2K-1 frames shrinks the key range
            usable = min(len(frames), (len(self.sharp[clip_id]) + 1) // 2)
            if num_keys is None:
                if usable >= 2:
                    self.index.append((clip_id, 0, usable))
            else:
                for start in range(0, usable - num_keys + 1, chunk_stride):
                    self.index.append((clip_id, start, num_keys))
        if not self.index:
            raise ValueError(
                f"no usable samples (num_keys={num_keys}) under {root}")

    def _loader(self):
        return lru_cache(maxsize=2048)(load_frame) if self.cache_frames \
            else load_frame

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        del state["_load"]  # an lru_cache wrapper does not pickle
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._load = self._loader()

    def __len__(self) -> int:
        return len(self.index)

    def _load_maybe_resize(self, path: str) -> np.ndarray:
        if self.raw_u8:
            return load_frame_u8(path)
        frame = self._load(path)
        if self.resize_to is not None and frame.shape[:2] != self.resize_to:
            image = pil_image()
            h, w = self.resize_to
            # float32 per channel: the antialiased triangle filter of uint8
            # BILINEAR without a second 8-bit quantization
            frame = np.stack(
                [np.asarray(image.fromarray(frame[..., c], mode="F")
                            .resize((w, h), image.BILINEAR))
                 for c in range(frame.shape[-1])], axis=-1).astype(np.float32)
        return frame

    def sample_hw(self, i: int) -> tuple[int, int]:
        """Sample ``i``'s frame size, from its first blurry frame's header
        (or ``resize_to``)."""
        if self.resize_to is not None:
            return tuple(self.resize_to)
        clip_id, start, _keys = self.index[i]
        path = self.blurry[clip_id][start]
        if path.endswith(".npy"):
            return tuple(np.load(path, mmap_mode="r").shape[:2])
        with pil_image().open(path) as im:
            return im.size[1], im.size[0]

    def sample_name(self, i: int) -> str:
        """The clip's id, with the start key for a chunk past the first."""
        clip_id, start, _keys = self.index[i]
        return clip_id if start == 0 else f"{clip_id}@{start}"

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        clip_id, start, keys = self.index[i]
        b_paths = self.blurry[clip_id][start: start + keys]
        s_paths = self.sharp[clip_id][2 * start: 2 * start + 2 * keys - 1]
        return {
            "blurry": np.stack([self._load_maybe_resize(p) for p in b_paths]),
            "sharp": np.stack([self._load_maybe_resize(p) for p in s_paths]),
        }
