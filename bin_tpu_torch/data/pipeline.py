"""Eval clips from a sample source, after ``bin_tpu/data/pipeline.py``.

A *source* is any object with:
  __len__() -> int
  __getitem__(i) -> {"blurry": (K, H, W, 3) f32, "sharp": (2K-1, H, W, 3) f32}

``SyntheticSource`` and ``eval_clips`` are copies of ``bin_tpu``'s, so the
port scores the same clips for the same seed, byte for byte.  The training
iterator and its crop/flip stay with the training slice.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from bin_tpu_torch.data import synthetic

__all__ = ["SyntheticSource", "eval_clips"]


class SyntheticSource:
    """Procedural source of blurry/sharp samples (see synthetic.py); sample
    ``i`` is rendered from seed ``seed * 1_000_003 + i``.  ``bin_tpu``'s
    training options (``cache``, ``as_u8``) are not carried."""

    def __init__(self, num_samples: int, num_keys: int, height: int, width: int,
                 taps: int = 11, stride: int = 8, seed: int = 0,
                 style: str = "smooth"):
        self.num_samples = num_samples
        self.num_keys = num_keys
        self.height = height
        self.width = width
        self.taps = taps
        self.stride = stride
        self.seed = seed
        self.style = style

    def __len__(self) -> int:
        return self.num_samples

    def sample_name(self, i: int) -> str:
        return f"synth{self.seed}_{i:04d}"

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        if not 0 <= i < self.num_samples:
            raise IndexError(i)
        return synthetic.make_sample(self.seed * 1_000_003 + i, self.num_keys,
                                     self.height, self.width, self.taps,
                                     self.stride, style=self.style)


def eval_clips(source, batch_size: int = 1) -> Iterator[dict[str, np.ndarray]]:
    """Deterministic full-frame eval batches, one pass over the source.

    Samples are grouped by shape before batching (full-clip sources yield
    clips of different lengths); trailing partial batches are padded by
    repeating the last clip of the group with a "valid" mask so metrics can
    ignore padding.  Clip names ride alongside, not stacked."""
    def emit(items: list[tuple[str, dict[str, np.ndarray]]]):
        valid = np.zeros((batch_size,), dtype=bool)
        valid[: len(items)] = True
        items = items + [items[-1]] * (batch_size - len(items))
        batch = {k: np.stack([it[k] for _, it in items]) for k in items[0][1]}
        batch["valid"] = valid
        batch["names"] = [name for name, _ in items]
        return batch

    def name_of(i: int) -> str:
        if hasattr(source, "sample_name"):
            return source.sample_name(i)
        return f"clip{i:04d}"

    buffers: dict[tuple, list] = {}
    for i in range(len(source)):  # single pass; <= batch_size items buffered
        item = source[i]          # per distinct clip shape
        buf = buffers.setdefault(item["blurry"].shape, [])
        buf.append((name_of(i), item))
        if len(buf) == batch_size:
            yield emit(buf)
            buf.clear()
    for buf in buffers.values():
        if buf:
            yield emit(buf)
